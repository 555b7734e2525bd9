"""``python -m py4cast_tpu_torch {fit,test,predict} --config ...``: the
port's command line (``py4cast_tpu_torch/cli.py``)."""

import sys

from py4cast_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
