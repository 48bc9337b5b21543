"""Operations and bytes of the recurrent model (models/rnn.py), counted
from shapes, f32 throughout.

An LSTM layer of width H over inputs of width `inp`, per row and time
step: its four gates' products 2 4H (inp + H) operations forward, twice
that backward (the gradients of the inputs and of the weights); the
gates' elementwise work is not counted. Bytes of one recurrent-op call
over B rows and T steps: the weights (4H (inp + H) and two 4H biases)
once, and per row and step the input (inp), the gates (4H) and the
states h and c (2H) once; backward adds the weights' gradient written
once and the input's gradient (inp) a row and step. The output layer,
2 H obs a row and step forward, belongs to a step's model FLOPs, not to
the recurrent op.
"""

F32 = 4


def lstm_row_step(inp, hidden):
    """Forward operations of one row and time step of an LSTM layer."""
    return 2 * 4 * hidden * (inp + hidden)


def _weights(inp, hidden):
    return 4 * hidden * (inp + hidden) + 2 * 4 * hidden


def lstm_forward(rows, steps, inp, hidden):
    """(operations, bytes) of one forward call over rows x steps."""
    flops = rows * steps * lstm_row_step(inp, hidden)
    n_bytes = F32 * (_weights(inp, hidden) +
                     rows * steps * (inp + 4 * hidden + 2 * hidden))
    return flops, n_bytes


def lstm_backward(rows, steps, inp, hidden):
    """(operations, bytes) of one backward call over rows x steps."""
    flops = 2 * rows * steps * lstm_row_step(inp, hidden)
    n_bytes = F32 * (2 * _weights(inp, hidden) +
                     rows * steps * (2 * inp + 4 * hidden + 2 * hidden))
    return flops, n_bytes


def rnn_row_step(inp, hidden, obs):
    """Forward model FLOPs of one row and time step: the LSTM's gates and
    the output layer."""
    return lstm_row_step(inp, hidden) + 2 * hidden * obs


def train_step_flops(batch, t_len, inp, hidden, obs):
    """Model FLOPs of one train step over batch paths of t_len steps: the
    forward F and its backward 2F, no recomputation."""
    return 3 * batch * t_len * rnn_row_step(inp, hidden, obs)
