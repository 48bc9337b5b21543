"""Shared building blocks for learned dynamics models (models/core.py).

MLP parameters are plain dicts {'w': [W_0, ...], 'b': [b_0, ...]} of
tensors, W_l (..., in_l, out_l) and b_l (..., out_l): leading axes, such as
the env axis of adapted parameters, broadcast through `mlp_forward`.
Recurrent cells keep the JAX package's layout {'wi': (in, kH), 'wh': (H,
kH), 'b': (kH,)}, with torch's gate order (LSTM i, f, g, o; GRU r, z, n).
"""
from typing import Sequence

import numpy as np
import torch

_ACTIVATIONS = {
    None: lambda x: x,
    'relu': torch.relu,
    'tanh': torch.tanh,
    'sigmoid': torch.sigmoid,
    'swish': lambda x: x * torch.sigmoid(x),
}


def activation(name):
    if callable(name):
        return name
    return _ACTIVATIONS[name]


def init_mlp(generator, in_dim: int, hidden_sizes: Sequence[int], out_dim: int,
             dtype=torch.float32, device='cpu'):
    """Xavier-uniform weights, zero biases. Returns {'w': [..], 'b': [..]}."""
    sizes = [in_dim] + list(hidden_sizes) + [out_dim]
    ws, bs = [], []
    for i in range(len(sizes) - 1):
        fan_in, fan_out = sizes[i], sizes[i + 1]
        limit = float(np.sqrt(6.0 / (fan_in + fan_out)))
        u = torch.rand((fan_in, fan_out), generator=generator, dtype=dtype,
                       device=device)
        ws.append(u * (2 * limit) - limit)
        bs.append(torch.zeros((fan_out,), dtype=dtype, device=device))
    return {'w': ws, 'b': bs}


def params_from_numpy(params, device, dtype=torch.float32):
    """{'w': [...], 'b': [...]} of arrays (e.g. jax.device_get of the JAX
    package's model.params) -> the same dict of tensors on `device`."""
    return {k: [torch.tensor(np.asarray(a), dtype=dtype, device=device)
                for a in params[k]] for k in ('w', 'b')}


def mlp_forward(params, x, hidden_nonlinearity='relu',
                output_nonlinearity=None, compute_dtype=None):
    """Feed-forward pass. With compute_dtype=torch.bfloat16 the products take
    bf16-rounded inputs and accumulate in f32 (JAX's preferred_element_type
    semantics): both operands are rounded to bf16 and widened back, and the
    product of two bf16 values is exact in f32."""
    act = activation(hidden_nonlinearity)
    out_act = activation(output_nonlinearity)
    n = len(params['w'])
    for i, (w, b) in enumerate(zip(params['w'], params['b'])):
        if compute_dtype is not None:
            xc = x.to(compute_dtype).to(x.dtype)
            wc = w.to(compute_dtype).to(x.dtype)
            x = torch.matmul(xc, wc) + b.unsqueeze(-2)
        else:
            x = torch.matmul(x, w) + b.unsqueeze(-2)
        x = act(x) if i < n - 1 else out_act(x)
    return x


# ---------------------------------------------------------------------------
# recurrent cells (ReBAL)
# ---------------------------------------------------------------------------

#: the LSTM's forget-gate bias, a constant and not a parameter (TF's
#: BasicLSTMCell default, which the reference relies on)
FORGET_BIAS = 1.0


def _init_cell(generator, in_dim, hidden, k, dtype, device):
    """Xavier-uniform wi (in, k*hidden) and wh (hidden, k*hidden) with the
    limit of the whole (in + hidden, k*hidden) kernel, zero b."""
    limit = float(np.sqrt(6.0 / (in_dim + hidden + k * hidden)))

    def uniform(shape):
        u = torch.rand(shape, generator=generator, dtype=dtype, device=device)
        return u * (2 * limit) - limit
    return {'wi': uniform((in_dim, k * hidden)),
            'wh': uniform((hidden, k * hidden)),
            'b': torch.zeros((k * hidden,), dtype=dtype, device=device)}


def init_lstm(generator, in_dim, hidden, dtype=torch.float32, device='cpu'):
    return _init_cell(generator, in_dim, hidden, 4, dtype, device)


def lstm_step(params, carry, x):
    h, c = carry
    gates = x @ params['wi'] + h @ params['wh'] + params['b']
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    c = (torch.sigmoid(f + FORGET_BIAS) * c +
         torch.sigmoid(i) * torch.tanh(g))
    h = torch.sigmoid(o) * torch.tanh(c)
    return (h, c), h


def init_gru(generator, in_dim, hidden, dtype=torch.float32, device='cpu'):
    return _init_cell(generator, in_dim, hidden, 3, dtype, device)


def gru_step(params, carry, x):
    """The hidden side has no bias: b is the input side's."""
    h = carry
    xr, xz, xn = torch.chunk(x @ params['wi'] + params['b'], 3, dim=-1)
    hr, hz, hn = torch.chunk(h @ params['wh'], 3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    h = (1 - z) * n + z * h
    return h, h


def init_rnn(generator, in_dim, hidden, dtype=torch.float32, device='cpu'):
    return _init_cell(generator, in_dim, hidden, 1, dtype, device)


def rnn_step(params, carry, x):
    h = torch.tanh(x @ params['wi'] + carry @ params['wh'] + params['b'])
    return h, h


def _zeros(bs, h, dtype, device):
    return torch.zeros((bs, h), dtype=dtype, device=device)


#: cell type -> (init, step, zero state (batch, hidden, dtype, device))
CELLS = {
    'lstm': (init_lstm, lstm_step,
             lambda bs, h, dt, dev: (_zeros(bs, h, dt, dev),
                                     _zeros(bs, h, dt, dev))),
    'gru': (init_gru, gru_step, _zeros),
    'rnn': (init_rnn, rnn_step, _zeros),
}
