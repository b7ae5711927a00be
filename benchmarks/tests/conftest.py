"""CPU tests of the benchmark. Run: ``python -m pytest benchmarks/tests -q``."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

# The CPU runs are many small ops: one thread each, so that test workers
# side by side do not oversubscribe the cores.
torch.set_num_threads(1)
