"""The protocol-neutral run layer the MultiPaxos roles share: chosen-run
logging (``records``), client request routing (``routing``) and the
client retry and staging mixins (``client``), copied from
``frankenpaxos_tpu/runs/``."""
