"""Seeding (``ray_lightning_tpu/utils/seed.py``), without the environment
variable: the port reads no env knobs."""
from __future__ import annotations

import random
from typing import Optional

import numpy as np
import torch


def seed_everything(seed: Optional[int] = None) -> int:
    """Seed Python's, numpy's and torch's generators (every device's) and
    return the seed; ``None`` draws one from the system's entropy."""
    if seed is None:
        seed = random.SystemRandom().randint(0, 2**31 - 1)
    seed = int(seed)
    random.seed(seed)
    np.random.seed(seed % (2**32))
    torch.manual_seed(seed)
    return seed
