"""Thread configuration.

Counterpart of ``pocomc_tpu/utils/threading.py``. Here ``pytorch_threads``
takes effect, as in the original pocoMC: it caps torch's intra-op threads
so that the host flow fit does not fight a likelihood pool for cores.
"""

from __future__ import annotations

import torch


def configure_threads(pytorch_threads=None):
    """Cap torch's intra-op threads at ``pytorch_threads`` (process-wide)."""
    if pytorch_threads is not None:
        torch.set_num_threads(int(pytorch_threads))
