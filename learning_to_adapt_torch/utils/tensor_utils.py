"""Numpy helpers for stacking and padding path dicts
(utils/tensor_utils.py of the JAX package, copied: it is numpy only)."""
import numpy as np
import scipy.signal


def discount_cumsum(x, discount):
    """y[t] = sum_{t'>=t} discount^(t'-t) x[t'] (scipy lfilter)."""
    return scipy.signal.lfilter([1], [1, float(-discount)], x[::-1],
                                axis=0)[::-1]


def stack_tensor_list(tensor_list):
    return np.asarray(tensor_list)


def stack_tensor_dict_list(tensor_dict_list):
    """list of dicts -> dict of stacked arrays (recursive)."""
    keys = list(tensor_dict_list[0].keys()) if tensor_dict_list else []
    ret = {}
    for k in keys:
        example = tensor_dict_list[0][k]
        if isinstance(example, dict):
            ret[k] = stack_tensor_dict_list([d[k] for d in tensor_dict_list])
        else:
            ret[k] = stack_tensor_list([d[k] for d in tensor_dict_list])
    return ret


def concat_tensor_list(tensor_list, recurrent=False):
    if recurrent:
        return np.stack(tensor_list, axis=0)
    return np.concatenate(tensor_list, axis=0)


def concat_tensor_dict_list(tensor_dict_list, recurrent=False):
    keys = list(tensor_dict_list[0].keys()) if tensor_dict_list else []
    ret = {}
    for k in keys:
        example = tensor_dict_list[0][k]
        if isinstance(example, dict):
            ret[k] = concat_tensor_dict_list(
                [d[k] for d in tensor_dict_list], recurrent)
        else:
            ret[k] = concat_tensor_list([d[k] for d in tensor_dict_list],
                                        recurrent)
    return ret


def pad_tensor(x, max_len, mode='zero'):
    padding = np.zeros_like(x[0]) if mode == 'zero' else x[-1]
    return np.concatenate([x, np.tile(padding, (max_len - len(x),) +
                                      (1,) * np.ndim(x[0]))])


def pad_tensor_n(xs, max_len):
    ret = np.zeros((len(xs), max_len) + xs[0].shape[1:], xs[0].dtype)
    for idx, x in enumerate(xs):
        ret[idx][:len(x)] = x
    return ret


def explained_variance_1d(ypred, y):
    assert y.ndim == 1 and ypred.ndim == 1
    vary = np.var(y)
    if np.isclose(vary, 0):
        return 0 if np.var(ypred) > 0 else 1
    return 1 - np.var(y - ypred) / (vary + 1e-8)


def normalize_advantages(advantages):
    return (advantages - np.mean(advantages)) / (np.std(advantages) + 1e-8)


def shift_advantages_to_positive(advantages):
    return (advantages - np.min(advantages)) + 1e-8
