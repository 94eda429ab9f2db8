"""WPaxos Replica: one per zone, executing every object group (the
port's copy of ``frankenpaxos_tpu/protocols/wpaxos/replica.py``).

Replicas are the exactly-once authority: each group's log executes in
slot order, with a per-(group, client, pseudonym) client table
filtering duplicate commands -- a command that reached two slots (a
client failover re-propose racing a steal's adopted vote) executes
once, whichever slot wins. The leader already acked the client at
chosen-time (zone-local); replicas exist for execution, reads, and the
chaos oracle (prefix agreement + exactly-once across replicas,
tests/test_torch_wpaxos.py).

Holes (a dropped WChosen) recover via a ``recover`` timer: ask every
leader for chosen values at or above the executed watermark -- any
leader that remembers the slot answers, including a steal's new owner
which re-proved the value from acceptor votes.
"""

from __future__ import annotations

from frankenpaxos_tpu_torch.protocols.wpaxos.config import WPaxosConfig
from frankenpaxos_tpu_torch.protocols.wpaxos.messages import (
    CommandBatch,
    WChosen,
    WRecover,
)
from frankenpaxos_tpu_torch.runtime import Actor, Logger
from frankenpaxos_tpu_torch.runtime.transport import Address, Transport


class WPaxosReplica(Actor):
    def __init__(self, address: Address, transport: Transport,
                 logger: Logger, config: WPaxosConfig,
                 recover_period_s: float = 1.0):
        super().__init__(address, transport, logger)
        config.check_valid()
        self.config = config
        self.zone = config.replica_addresses.index(address)
        # Per group: chosen log, contiguous executed watermark, the
        # executed payload sequence (the AppendLog-flavored SM), and
        # the max slot we have HEARD of (hole detection).
        self.logs: list[dict] = [dict() for _ in range(config.num_groups)]
        self.executed_watermark: list[int] = [0] * config.num_groups
        self.executed: list[list] = [[] for _ in range(config.num_groups)]
        self.max_known_slot: list[int] = [-1] * config.num_groups
        # (group, client, pseudonym) -> highest executed client_id.
        self.client_table: dict = {}
        self.recover_timer = self.timer("recover", recover_period_s,
                                        self._recover)

    def receive(self, src: Address, message) -> None:
        if isinstance(message, WChosen):
            self._handle_chosen(src, message)
        else:
            self.logger.fatal(f"unexpected replica message {message!r}")

    def _handle_chosen(self, src: Address, m: WChosen) -> None:
        if not 0 <= m.group < self.config.num_groups:
            return
        log = self.logs[m.group]
        if m.slot not in log:
            log[m.slot] = m.value
        self.max_known_slot[m.group] = max(self.max_known_slot[m.group],
                                           m.slot)
        self._execute(m.group)
        if self.max_known_slot[m.group] >= \
                self.executed_watermark[m.group] \
                and not self.recover_timer.running:
            self.recover_timer.start()

    def _execute(self, group: int) -> None:
        log = self.logs[group]
        wm = self.executed_watermark[group]
        while wm in log:
            value = log[wm]
            if isinstance(value, CommandBatch):
                for command in value.commands:
                    cid = command.command_id
                    key = (group, cid.client_address,
                           cid.client_pseudonym)
                    if cid.client_id > self.client_table.get(key, -1):
                        self.client_table[key] = cid.client_id
                        self.executed[group].append(command.command)
            wm += 1
        self.executed_watermark[group] = wm

    def _recover(self) -> None:
        """Ask every leader to refill holes in any lagging group."""
        lagging = False
        for group in range(self.config.num_groups):
            if self.max_known_slot[group] >= \
                    self.executed_watermark[group]:
                lagging = True
                self.broadcast(
                    self.config.leader_addresses,
                    WRecover(group=group,
                             slot=self.executed_watermark[group]))
        if lagging:
            self.recover_timer.start()

    # --- oracle views (tests) ----------------------------------------------
    def group_sequences(self) -> tuple:
        return tuple(tuple(seq) for seq in self.executed)
