"""The client-side retry discipline (``backoff``) and the ``Rejected``
reply (``messages``), copied from ``frankenpaxos_tpu/serve/``. Admission
control itself is not ported yet (ROADMAP.md queue 1 item 8.1)."""
