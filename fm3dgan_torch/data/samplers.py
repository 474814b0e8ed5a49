"""Index samplers for dual-supervision training (dataset.py:163-337): the
port's copy of ``fm3dgan/data/samplers.py``."""

from __future__ import annotations

from typing import List

import numpy as np


def dual_supervision_indices(
    n_images: int, n_img_per_id: int, rng: np.random.RandomState
) -> List[int]:
    """Random permutation expanded to same-identity/different-variation pairs
    (dual_supervision_list_augmentation, dataset.py:166-191): yields 2*n
    indices where (2j, 2j+1) share an identity but differ in variation."""
    out: List[int] = []
    for idx in rng.permutation(n_images):
        person = idx // n_img_per_id
        var = idx % n_img_per_id
        choices = [i for i in range(n_img_per_id) if i != var]
        dual = person * n_img_per_id + rng.choice(choices)
        out += [int(idx), int(dual)]
    return out


def extreme_pose_indices(
    n_images: int, n_img_per_id: int, rng: np.random.RandomState
) -> List[int]:
    """Per identity: (normal-pose idx = id*n, random extreme idx)
    (extreme_pose_list_augmentation, dataset.py:310-337)."""
    out: List[int] = []
    for pid in rng.permutation(n_images // n_img_per_id):
        normal = int(pid) * n_img_per_id
        out.append(normal)
        out.append(normal + int(rng.choice(np.arange(1, n_img_per_id))))
    return out


def swap_list_pair(n: int) -> List[int]:
    """[0,1,2,3,...] -> [1,0,3,2,...] — the editing swap: render of sample
    i+1 paired with photo of sample i (Swap_List_Pair, dataset.py:343-358)."""
    out = []
    for i in range(n):
        out.append(i + 1 if i % 2 == 0 else i - 1)
    return out
