"""Trees of tensors: mapping over them, and carrying the JAX package's
params, caches and states across to the port.

A tree is nested dicts, lists and tuples whose leaves are arrays (or
None), the layout of the JAX package's pytrees.  ``params_from_numpy``
takes such a tree with numpy leaves -- the JAX side makes it with
``jax.tree.map(np.asarray, params)`` -- and returns the port's tree of
tensors; ``train_state_from_numpy`` does the same for a whole training
state.  This module imports neither ``jax`` nor ``repro``.
"""

from __future__ import annotations

import numpy as np
import torch


def tree_map(fn, tree, *rest, is_leaf=None):
    """``fn`` over the leaves of ``tree`` (and the leaves at the same place
    in each tree of ``rest``), keeping the structure (named tuples too);
    None stays None, and a node for which ``is_leaf`` holds (a spec tuple,
    say) is a leaf."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
               for i, v in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") \
            else type(tree)(out)
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_map_with_path(fn, tree, *rest, is_leaf=None, prefix: tuple = ()):
    """``fn(path, leaf, *rest_leaves)`` at each leaf, as ``tree_map``, but
    visited in JAX's flatten order (a dict's keys sorted, a named tuple's
    fields and a list's items in turn), so that every rank of a world
    meets the leaves in one order.  ``path`` is JAX's key path string:
    dict keys and list indices as they are, a named tuple's field as
    ``.name``, joined by "/"."""
    if is_leaf is not None and is_leaf(tree):
        return fn("/".join(prefix), tree, *rest)
    if isinstance(tree, dict):
        mapped = {k: tree_map_with_path(fn, tree[k], *(r[k] for r in rest),
                                        is_leaf=is_leaf,
                                        prefix=prefix + (str(k),))
                  for k in sorted(tree)}
        return {k: mapped[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        named = getattr(tree, "_fields", None)
        out = [tree_map_with_path(fn, v, *(r[i] for r in rest),
                                  is_leaf=is_leaf, prefix=prefix + (
                                      f".{named[i]}" if named else str(i),))
               for i, v in enumerate(tree)]
        return type(tree)(*out) if named else type(tree)(out)
    if tree is None:
        return None
    return fn("/".join(prefix), tree, *rest)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def tensor_from_numpy(a, device, dtype: torch.dtype | None = None
                      ) -> torch.Tensor:
    """One numpy array (bf16 arrays too, as JAX hands them out) as a tensor
    on ``device``; floating arrays cast to ``dtype`` when it is given."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # numpy's bf16 extension type
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16)
                             .copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree, device, dtype: torch.dtype | None = None):
    """The JAX package's params (or cache, or state), as nested dicts and
    lists of numpy arrays, as the port's tree of tensors on ``device``."""
    return tree_map(lambda a: tensor_from_numpy(a, device, dtype), tree)


def train_state_from_numpy(state, device):
    """The JAX package's ``TrainState`` (``(params, (m, v, step))`` with
    numpy leaves, ``jax.tree.map(np.asarray, state)``) as the port's
    ``training.train_step.TrainState`` on ``device``, dtypes kept (bf16
    moments too), so that both packages step from the same state."""
    from repro_torch.training.optimizer import OptState
    from repro_torch.training.train_step import TrainState
    params, (m, v, step) = state
    return TrainState(params=params_from_numpy(params, device),
                      opt=OptState(m=params_from_numpy(m, device),
                                   v=params_from_numpy(v, device),
                                   step=tensor_from_numpy(step, device)))
