"""MultiPaxos in the port: the cluster configuration (``config``) and
the ProxyLeader's Phase2b vote tracking (``quorum_tracker``). The roles
themselves wait for the port of the host runtime."""
