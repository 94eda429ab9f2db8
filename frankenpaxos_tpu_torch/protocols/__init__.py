"""Protocol modules of the port: MultiPaxos, EPaxos, SimpleBPaxos,
SimpleGcBPaxos, WPaxos, Fast Paxos and Fast MultiPaxos (``ROADMAP.md``
queue 1 lists the rest)."""
