"""Deliberate durable-ack violations (lint fixture of the port's linter,
excluded from the default walk by GLOBAL_EXCLUDES)."""


class BadPool:
    def run_round_publish_first(self, live, res, lanes, pad, state):
        epoch = self._publish(state)  # LINT-EXPECT: durable-ack
        self._wal_commit(live, res, lanes, pad)
        return epoch

    def ack_without_wal(self, live, res):
        for t in live:
            t.status = "applied"  # LINT-EXPECT: durable-ack
        return res

    def fine_round(self, live, res, lanes, pad, state):
        self._wal_commit(live, res, lanes, pad)
        epoch = self._publish(state)
        for t in live:
            t.status = "applied"
        return epoch

    def fine_unrelated_status(self, t):
        t.status = "aborted"
        return t
