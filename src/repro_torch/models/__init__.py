"""The port's LMs (``repro.models``): ``layers``, ``attention``,
``transformer`` (the trunk kinds "global", "local", "moe", "ssm", "rec"),
``moe``, ``ssm``, ``rglru``, ``encdec`` and ``model`` (``build_model``:
``Model`` for the decoder-only families, ``EncDecModel`` for whisper)."""
