"""``python -m repro_torch.analysis`` — the port's lint gate (DESIGN.md
§15)."""
import sys

from repro_torch.analysis.cli import main

sys.exit(main())
