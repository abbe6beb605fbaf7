"""Helpers shared by the stage-A training tests of the port: flax trees of
numpy leaves, perturbed and flattened, and the relative L2 distance."""

import jax
import numpy as np


def perturbed(variables, seed=0, scale=0.1):
    """Every leaf plus ``scale`` × standard normal noise from ``seed``."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32) + scale * rng.randn(*np.shape(x)).astype(np.float32),
        variables)


def flat(tree, prefix=()):
    """A nested mapping → ``{path tuple: numpy leaf}``."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
