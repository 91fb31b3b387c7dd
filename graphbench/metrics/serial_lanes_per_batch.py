"""serial_lanes_per_batch (mutation): the lanes of a batch that the serial
correction pass applies one by one (on a CUDA state, one launch of the
``serial_pass`` kernel on the card; the host pass for CPU states), the
mean over the ``ops.apply`` spans of the second part of a traced window
(their ``serial_lanes``: the lanes ``_lane_conflicts`` marks, or every
lane where the allocation schedule overflowed and the whole batch was
replayed). Nothing where the program records no such span."""


def read(ctx):
    lanes = [e["args"]["serial_lanes"] for e in ctx.program_spans
             if e.get("ph") == "X" and e["name"] == "ops.apply"
             and "serial_lanes" in e.get("args", {})]
    return sum(lanes) / len(lanes) if lanes else None
