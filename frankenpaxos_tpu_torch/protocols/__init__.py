"""Protocol modules of the port. Only the MultiPaxos quorum tracking and
configuration are ported so far."""
