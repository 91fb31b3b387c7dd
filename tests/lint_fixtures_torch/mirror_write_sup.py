"""Suppressed mirror-write violation (lint fixture)."""


def allowed_replace(state, adj):
    # one-sided on purpose: this fixture pins that inline allows work
    return state._replace(adj_packed=adj)  # repro-torch-lint: allow(mirror-write)
