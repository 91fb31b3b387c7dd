"""The port's serving runtime (DESIGN.md §12, §13): ``fault`` (crash plans,
heartbeats, restart budget), ``ingest`` (the multi-tenant admission pool)
and ``serve_loop`` (``GraphCoServer``'s graph endpoints).

Importing this package loads none of them; import the module you need.
"""
