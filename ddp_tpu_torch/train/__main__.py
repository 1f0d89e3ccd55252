"""``python -m ddp_tpu_torch.train [--model simple_cnn|causal_lm] [flags]``.

Trains on the GPU (``--device cpu`` runs on the CPU, over gloo);
``--spawn N`` starts N local ranks. ``--help`` lists the flags.
"""

import sys

from ddp_tpu_torch.train.trainer import main

if __name__ == "__main__":
    main()
    sys.exit(0)
