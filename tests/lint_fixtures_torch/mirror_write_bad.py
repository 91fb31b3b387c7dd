"""Deliberate mirror-write violations (lint fixture of the port's linter,
excluded from the default walk by GLOBAL_EXCLUDES)."""


def bad_replace(state, adj):
    return state._replace(adj_packed=adj)  # LINT-EXPECT: mirror-write


def bad_construct(GraphState, vkey, valive, vver, ecnt, adj):
    return GraphState(vkey, valive, vver, ecnt, adj_packed=adj)  # LINT-EXPECT: mirror-write


def bad_sharded(ShardedGraphState, mesh, vkey, valive, vver, ecnt, adj):
    return ShardedGraphState(mesh, vkey, valive, vver, ecnt, adj)  # LINT-EXPECT: mirror-write


def fine_metadata_only(state, ver):
    return state._replace(vver=ver)


def fine_both(state, adj, adj_in):
    return state._replace(adj_packed=adj, adj_in_packed=adj_in)


def fine_sharded(ShardedGraphState, mesh, vkey, valive, vver, ecnt, adj,
                 adj_in):
    return ShardedGraphState(mesh, vkey, valive, vver, ecnt, adj, adj_in)
