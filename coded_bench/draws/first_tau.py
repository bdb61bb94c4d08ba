"""Survivors are the first tau of the K workers to finish, all orders
equally likely: the survivor set is uniform over the sets of size tau."""
import numpy as np


def draw(rng: np.random.Generator, n: int, K: int, tau: int, params: dict) -> list:
    """n requests' ``{"mask": (K,) 0/1}``."""
    order = rng.permuted(np.tile(np.arange(K), (n, 1)), axis=1)
    masks = np.zeros((n, K))
    np.put_along_axis(masks, order[:, :tau], 1.0, axis=1)
    return [{"mask": mask} for mask in masks]
