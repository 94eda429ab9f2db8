"""Leader election (the port's copy of ``frankenpaxos_tpu/election/``)."""
