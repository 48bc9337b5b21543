"""Offline trajectory renderer on the port (tools/render_trajectory.py of
the JAX package, on the port's physics).

Reads a replay .npz (from `python -m learning_to_adapt_torch.sim_policy`)
and renders the articulated body as a 2-D stick figure strip (x-z plane;
capsule segments from forward kinematics) to a PNG.

    python -m learning_to_adapt_torch.render_trajectory \
        data/grbal_torch/<exp>/replay.npz --env half_cheetah [--device cpu]

Forward kinematics (engine.forward, one kernel launch on the card) runs
once over all kept frames, the frame axis taking the place of the env
axis. Runs on the card unless --device cpu is given; without a card it
raises. matplotlib is needed only by main().
"""
import argparse

import numpy as np
import torch

from learning_to_adapt_torch.device import resolve_device
from learning_to_adapt_torch.envs.model_defs import get_model
from learning_to_adapt_torch.physics import engine, spec


def render_frames(qpos_seq, model, stride=20, device=None):
    """Returns a list of (segments, spheres) per frame: world-space capsule
    endpoints / sphere centers from FK, at the model's nominal geometry
    (default_mutable), for qpos_seq[::stride]. segments: (e1, e2, radius),
    spheres: (center, radius). device None: the card."""
    device = resolve_device('cuda' if device is None else device)
    kept = np.asarray(qpos_seq)[::stride]
    if len(kept) == 0:
        return []
    qpos = torch.as_tensor(kept, dtype=torch.float32, device=device)
    mt = engine.model_tensors(model, device, torch.float32)
    mm = spec.batched_mutable(spec.default_mutable(model), len(kept),
                              device, torch.float32)
    # the frames of engine.forward: on the card one launch of its kernel
    data = engine.forward(model, mm, engine.PhysicsState(
        qpos=qpos, qvel=qpos.new_zeros((len(kept), model.nv))))
    gpos, gmat = engine._geom_frames(mt, mm, data.xpos, data.ximat)
    gpos = gpos.cpu().numpy()   # (frames, ngeom, 3)
    gmat = gmat.cpu().numpy()   # (frames, ngeom, 3, 3)

    # per geom, the same host arithmetic as the JAX tool, over all frames
    segs, spheres = [], []
    for gi in range(model.ngeom):
        t = int(model.geom_type[gi])
        size = model.geom_size0[gi]
        if t == spec.CAPSULE:
            axis = gmat[:, gi, :, 2]
            segs.append((gpos[:, gi] + axis * size[1],
                         gpos[:, gi] - axis * size[1], size[0]))
        elif t == spec.SPHERE:
            spheres.append((gpos[:, gi], size[0]))
        elif t == spec.BOX:
            axis = gmat[:, gi, :, 0]
            segs.append((gpos[:, gi] + axis * size[0],
                         gpos[:, gi] - axis * size[0], size[2]))
    return [([(e1[f], e2[f], r) for e1, e2, r in segs],
             [(c[f], r) for c, r in spheres]) for f in range(len(kept))]


def main(argv=None):
    p = argparse.ArgumentParser(
        prog='python -m learning_to_adapt_torch.render_trajectory')
    p.add_argument('replay', type=str)
    p.add_argument('--env', type=str, default='half_cheetah')
    p.add_argument('--rollout', type=int, default=0)
    p.add_argument('--stride', type=int, default=25)
    p.add_argument('--out', type=str, default=None)
    p.add_argument('--device', type=str, default='cuda',
                   help="torch device; 'cpu' runs without a card")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    model = get_model(args.env)
    data = np.load(args.replay)
    qpos_seq = data['qpos'][args.rollout]
    frames = render_frames(qpos_seq, model, stride=args.stride,
                           device=device)

    n = len(frames)
    cols = min(n, 8)
    rows = (n + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(2.2 * cols, 2.2 * rows))
    axes = np.atleast_1d(axes).ravel()
    for ax in axes:
        ax.axis('off')
    for i, (segs, spheres) in enumerate(frames):
        ax = axes[i]
        for e1, e2, r in segs:
            ax.plot([e1[0], e2[0]], [e1[2], e2[2]], lw=max(r * 40, 1),
                    solid_capstyle='round', color='tab:brown')
        for c, r in spheres:
            ax.add_patch(plt.Circle((c[0], c[2]), r, color='tab:orange'))
        ax.axhline(0, color='gray', lw=0.5)
        ax.set_aspect('equal')
        ax.set_xlim(qpos_seq[:, 0].min() - 1, qpos_seq[:, 0].max() + 1)
        ax.set_ylim(-0.2, 1.6)
        ax.set_title(f't={i * args.stride}', fontsize=7)
    out = args.out or args.replay.replace('.npz', '.png')
    fig.tight_layout()
    fig.savefig(out, dpi=110)
    plt.close(fig)
    print(f'wrote {out} ({n} frames)')
    return out


if __name__ == '__main__':
    main()
