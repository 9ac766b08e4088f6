"""``python -m sagecal_tpu_torch.analysis [paths...]`` — run the lint
gate."""

import sys

from sagecal_tpu_torch.analysis.cli import run

if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
