"""Benchmarking: the device-resident MultiPaxos pipeline and its
single-GPU headline."""
