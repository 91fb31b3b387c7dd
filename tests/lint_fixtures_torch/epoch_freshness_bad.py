"""Deliberate raw index-read violations (lint fixture)."""
import repro_torch.index.query  # LINT-EXPECT: epoch-freshness
from repro_torch.index import query  # LINT-EXPECT: epoch-freshness
from repro_torch.index.query import query_reach  # LINT-EXPECT: epoch-freshness


def bad_reach(idx, s, t):
    return query_reach(idx, s, t)  # LINT-EXPECT: epoch-freshness


def bad_counts(idx, slots):
    return query.reach_counts(idx, slots)  # LINT-EXPECT: epoch-freshness
