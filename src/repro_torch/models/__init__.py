"""The port's decoder-only LM (``repro.models`` for the trunk kinds
``"global"`` and ``"local"``): ``layers``, ``attention``, ``transformer``
and ``model`` (``build_model``). The MoE, SSM, RG-LRU and
encoder-decoder modules wait for ROADMAP.md queue A12."""
