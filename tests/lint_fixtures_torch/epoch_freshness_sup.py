"""Suppressed raw index read (lint fixture)."""


def allowed_reach(query_mod, idx, s, t):
    # differential harness: compares raw vs session answers on purpose
    return query_mod.query_reach(idx, s, t)  # repro-torch-lint: allow(epoch-freshness)
