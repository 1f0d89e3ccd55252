"""``python -m ddp_tpu_torch.train --model causal_lm [flags]``.

Trains the causal LM on one GPU (``--device cpu`` runs it on the CPU,
for tests); ``--help`` lists the flags.
"""

import sys

from ddp_tpu_torch.train.trainer import main

if __name__ == "__main__":
    main()
    sys.exit(0)
