"""Suppressed durable-ack violation (lint fixture)."""


class AllowedPool:
    def replay_publish(self, state, live):
        # recovery replay re-publishes already-durable rounds on purpose
        epoch = self._publish(state)  # repro-torch-lint: allow(durable-ack)
        for t in live:
            t.status = "applied"  # repro-torch-lint: allow(durable-ack)
        return epoch
