"""The dynamics models' mathematics, written out plainly: normalization,
the MLP, GrBAL's inner step and second-order meta loss, MB-MPC's
weighted loss, the global-norm clip with Adam, and random shooting's
returns. The precision of each product is the caller's (lib/precision.py
RoundedProducts); everything else is f32, or f64 where asked."""
import torch

EPS = 1e-10
ACT = {'relu': torch.relu, 'tanh': torch.tanh}


def normalizer(obs, act, delta):
    """Per-dimension mean and std (population) over every leading axis of
    each array, computed in f64 and returned in f32."""
    def stats(x):
        x = x.reshape(-1, x.shape[-1]).double()
        return (x.mean(0).float(), x.std(0, correction=0).float())
    out = {}
    for key, x in (('obs', obs), ('act', act), ('delta', delta)):
        out[key + '_mean'], out[key + '_std'] = stats(x)
    return out


def norm(x, stats, key):
    return (x - stats[key + '_mean']) / (stats[key + '_std'] + EPS)


def mlp(ws, bs, x, nonlinearity='relu'):
    """x (..., R, in); ws[l] (..., in, out), bs[l] (..., out) broadcast over
    the leading axes; identity output."""
    act = ACT[nonlinearity]
    for i, (w, b) in enumerate(zip(ws, bs)):
        x = torch.matmul(x, w) + b.unsqueeze(-2)
        if i < len(ws) - 1:
            x = act(x)
    return x


def mse(ws, bs, x, target, nonlinearity):
    """Mean squared error over the last two axes."""
    return torch.square(mlp(ws, bs, x, nonlinearity) - target).mean(
        dim=(-2, -1))


def adapt(ws, bs, stats, obs, act, nxt, lr, nonlinearity):
    """GrBAL's per-window inner step: one gradient step at rate lr on each
    window's (obs, act, next obs) (S, K, d). Returns (ws, bs) with a
    leading window axis, detached."""
    s = obs.shape[0]
    with torch.enable_grad():
        leaves = [p.detach().unsqueeze(0).expand(s, *p.shape).clone()
                  .requires_grad_(True) for p in list(ws) + list(bs)]
        w, b = leaves[:len(ws)], leaves[len(ws):]
        x = torch.cat([norm(obs, stats, 'obs'), norm(act, stats, 'act')],
                      dim=-1)
        target = norm(nxt - obs, stats, 'delta')
        loss = mse(w, b, x, target, nonlinearity).sum()
        grads = torch.autograd.grad(loss, leaves)
    new = [p.detach() - lr * g for p, g in zip(leaves, grads)]
    return new[:len(ws)], new[len(ws):]


def planner_returns(ws, bs, stats, obs0, cand, dt, discount, nonlinearity):
    """Random shooting's model returns. obs0 (S, d); cand (H, S, n, A).
    Returns (S, n): sum over the horizon of discount^h times the planner
    reward, (x_com' - x_com) / dt - 0.05 |a|^2, along the model's
    predictions obs' = obs + denormalized delta. ws[l] is (in, out) for one
    set or (S, in, out) for one a sample."""
    o = obs0.unsqueeze(1).expand(-1, cand.shape[2], -1)
    ret = torch.zeros(o.shape[:2], dtype=o.dtype, device=o.device)
    for h in range(cand.shape[0]):
        a = cand[h]
        x = torch.cat([norm(o, stats, 'obs'), norm(a, stats, 'act')], dim=-1)
        delta = mlp(ws, bs, x, nonlinearity)
        nxt = o + (delta * (stats['delta_std'] + EPS) + stats['delta_mean'])
        r = (nxt[..., -3] - o[..., -3]) / dt - 0.1 * 0.5 * torch.sum(
            a * a, dim=-1)
        ret = ret + (discount ** h) * r
        o = nxt
    return ret


def meta_loss(ws, bs, stats, obs, act, nxt, inner_lr, k, nonlinearity):
    """GrBAL's second-order meta loss on windows (T, 2k, d): each task's
    params take one inner step on its first k rows, and the post-update
    loss on its last k rows is averaged over the tasks; the inner step is
    differentiated through. Returns (post, pre), each a mean over tasks."""
    t = obs.shape[0]
    x = torch.cat([norm(obs, stats, 'obs'), norm(act, stats, 'act')], dim=-1)
    target = norm(nxt - obs, stats, 'delta')
    tw = [w.unsqueeze(0).expand(t, *w.shape) for w in ws]
    tb = [b.unsqueeze(0).expand(t, *b.shape) for b in bs]
    pre = mse(tw, tb, x[:, :k], target[:, :k], nonlinearity)
    grads = torch.autograd.grad(pre.sum(), tw + tb, create_graph=True)
    new = [p - inner_lr * g for p, g in zip(tw + tb, grads)]
    post = mse(new[:len(ws)], new[len(ws):], x[:, k:], target[:, k:],
               nonlinearity)
    return post.mean(), pre.mean()


def weighted_loss(ws, bs, stats, obs, act, nxt, weight, nonlinearity):
    """MB-MPC's loss on rows (R, d): the squared error's mean over the
    output dims, weighted by row, over max(sum of weights, 1)."""
    x = torch.cat([norm(obs, stats, 'obs'), norm(act, stats, 'act')], dim=-1)
    err = torch.square(mlp(ws, bs, x, nonlinearity) -
                       norm(nxt - obs, stats, 'delta')).mean(-1)
    return torch.sum(err * weight) / torch.clamp(weight.sum(), min=1.0)


class Adam:
    """Global-norm clip (kept where the norm is under max_norm, else scaled
    onto it), then Adam with bias correction, leaf by leaf."""

    def __init__(self, params, lr, max_norm=100.0, b1=0.9, b2=0.999,
                 eps=1e-8):
        self.lr, self.max_norm, self.b1, self.b2, self.eps = (
            lr, max_norm, b1, b2, eps)
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, params, grads):
        """Returns (new params, the clipped gradients)."""
        total = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        if total >= self.max_norm:
            grads = [g / total * self.max_norm for g in grads]
        self.t += 1
        out = []
        for i, (p, g) in enumerate(zip(params, grads)):
            self.m[i] = self.b1 * self.m[i] + (1 - self.b1) * g
            self.v[i] = self.b2 * self.v[i] + (1 - self.b2) * g * g
            mhat = self.m[i] / (1 - self.b1 ** self.t)
            vhat = self.v[i] / (1 - self.b2 ** self.t)
            out.append(p - self.lr * mhat / (torch.sqrt(vhat) + self.eps))
        return out, grads
