"""ops layer of the PyTorch/CUDA port.

Importing the package registers the kernels' custom ops (the
``picklebot`` namespace of ``ops/library.py``), which a program saved by
``export.py`` needs to load.
"""

from picklebot_tpu_torch.ops import (flash_attention, folded_conv,  # noqa: F401
                                     fused_bottleneck)
