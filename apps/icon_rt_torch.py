#!/usr/bin/env python
"""icon_rt on PyTorch/CUDA: the CLI of apps/icon_rt.py plus --device
(default cuda).  See icon_rt_tpu_torch/app.py.

    python apps/icon_rt_torch.py --synthetic 8:16 --size 1920 1080 \
        --sample-limit 16
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from icon_rt_tpu_torch.app import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
