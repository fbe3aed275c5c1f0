"""Full float32 on the card: no TF32 in matmuls or convolutions.

Every module that runs torch math on the card imports this one
(``kernels/ops.py``, ``models/layers.py``), so both flags are set before
the first product, while ``import repro_torch`` and ``repro_torch.api``
stay free of torch.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
