"""The port's renderer (learning_to_adapt_torch/render_trajectory.py,
interactive_viewer.py) against the JAX package's replay tools
(tools/render_trajectory.py, tools/interactive_viewer.py, loaded by
importlib as tests/test_replay_e2e.py loads them): forward kinematics on
seeded qpos sequences for all five models, the page template, the HTML
payload of one replay, a port replay rendered end to end on the CPU, and
both modules used in a process where jax cannot be imported. The JAX side
is imported by the fixture `tools`, so the card's case is collected where
jax is not installed."""
import importlib
import importlib.util
import json
import os
import re
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from learning_to_adapt_torch import interactive_viewer as port_viewer
from learning_to_adapt_torch import render_trajectory as port_render
from learning_to_adapt_torch import sim_policy as port_sim
from learning_to_adapt_torch.envs.model_defs import get_model as port_model

from _torch_parity import tiny_snapshot

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = ['half_cheetah', 'half_cheetah_hfield', 'half_cheetah_blocks',
          'ant', 'arm_7dof']
ATOL = 1e-5
HTML_ATOL = 2e-4  # both round to 4 places


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        f'tool_{name}', os.path.join(_REPO, 'tools', f'{name}.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope='module')
def tools():
    """The JAX tools and the JAX package's models."""
    return SimpleNamespace(
        render=_load_tool('render_trajectory'),
        viewer=_load_tool('interactive_viewer'),
        get_model=importlib.import_module(
            'learning_to_adapt_tpu.envs.model_defs').get_model)


def _qpos_seq(model, n_frames, seed):
    """Seeded qpos around the reference pose; free-joint quaternions
    normalised."""
    rng = np.random.RandomState(seed)
    q = (model.qpos0[None] + 0.3 * rng.randn(n_frames, model.nq))
    for j in range(model.njnt):
        if int(model.jnt_type[j]) == 0:  # free joint
            a = int(model.jnt_qposadr[j])
            q[:, a + 3:a + 7] /= np.linalg.norm(q[:, a + 3:a + 7], axis=1,
                                                keepdims=True)
    return q.astype(np.float32)


def _assert_frames_close(got, want, atol):
    assert len(got) == len(want)
    for (segs, spheres), (wsegs, wspheres) in zip(got, want):
        assert len(segs) == len(wsegs) and len(spheres) == len(wspheres)
        for (e1, e2, r), (w1, w2, wr) in zip(segs, wsegs):
            np.testing.assert_allclose(e1, w1, rtol=0, atol=atol)
            np.testing.assert_allclose(e2, w2, rtol=0, atol=atol)
            np.testing.assert_allclose(r, wr, rtol=0, atol=atol)
        for (c, r), (wc, wr) in zip(spheres, wspheres):
            np.testing.assert_allclose(c, wc, rtol=0, atol=atol)
            np.testing.assert_allclose(r, wr, rtol=0, atol=atol)


@pytest.mark.parametrize('name', MODELS)
def test_render_frames_match_the_jax_tool(tools, name):
    """12 frames at stride 3: the same segments (capsules along z, boxes
    along x), radii and spheres as the JAX tool's per-frame FK."""
    jm, pm = tools.get_model(name), port_model(name)
    qpos = _qpos_seq(jm, 12, seed=MODELS.index(name))
    want = tools.render.render_frames(qpos, jm, stride=3)
    got = port_render.render_frames(qpos, pm, stride=3, device='cpu')
    assert len(got) == 4
    assert sum(len(s) + len(b) for s, b in got) > 0
    _assert_frames_close(got, want, ATOL)


def test_render_frames_keep_the_tools_structure(tools):
    """A frame is (segments, spheres) of numpy arrays; an empty sequence
    gives no frame."""
    pm = port_model('ant')
    frames = port_render.render_frames(_qpos_seq(pm, 5, 0), pm, stride=2,
                                       device='cpu')
    segs, spheres = frames[0]
    e1, e2, r = segs[0]
    assert isinstance(e1, np.ndarray) and e1.shape == (3,)
    assert isinstance(e2, np.ndarray) and np.ndim(r) == 0
    assert isinstance(spheres[0][0], np.ndarray)
    assert port_render.render_frames(np.zeros((0, pm.nq)), pm,
                                     device='cpu') == []


@pytest.mark.skipif(torch.cuda.is_available(), reason='a card is present')
def test_renderer_runs_on_the_card_unless_told_otherwise(tmp_path):
    """Without --device cpu the renderer asks for the card and raises
    without one; nothing falls back to the CPU on its own."""
    pm = port_model('half_cheetah')
    with pytest.raises(RuntimeError, match='device'):
        port_render.render_frames(_qpos_seq(pm, 3, 0), pm)
    npz = str(tmp_path / 'r.npz')
    np.savez(npz, qpos=_qpos_seq(pm, 8, 0)[None],
             rewards=np.zeros((1, 8), np.float32))
    with pytest.raises(RuntimeError, match='device'):
        port_render.main([npz])
    with pytest.raises(RuntimeError, match='device'):
        port_viewer.main([npz])


def test_page_is_the_tools_page(tools):
    assert port_viewer._PAGE == tools.viewer._PAGE


def _payload(path):
    page = open(path).read()
    return json.loads(re.search(r'const D = (\{.*?\});\n', page,
                                re.S).group(1))


@pytest.fixture(scope='module')
def replay(tmp_path_factory):
    """A port replay: a tiny GrBAL snapshot trained on the CPU, replayed
    by the port's sim_policy for 2 x 20 steps."""
    root = str(tmp_path_factory.mktemp('render'))
    exp = tiny_snapshot(root, 'grbal')
    out = os.path.join(root, 'replay.npz')
    port_sim.main([exp, '--max_path_length', '20', '--num_rollouts', '2',
                   '--device', 'cpu', '--out', out])
    return out


def test_export_html_payload_matches_the_jax_tool(tools, replay, tmp_path):
    """The same replay through both viewers: the same keys and frame count,
    every value within 2e-4."""
    want = _payload(tools.viewer.export_html(
        replay, 'half_cheetah', rollout=1, stride=3,
        out=str(tmp_path / 'jax.html')))
    got = _payload(port_viewer.export_html(
        replay, 'half_cheetah', rollout=1, stride=3,
        out=str(tmp_path / 'port.html'), device='cpu'))
    assert sorted(got) == sorted(want)
    assert len(got['frames']) == len(want['frames']) == 7
    assert got['stride'] == want['stride'] and got['T'] == want['T']
    for k in ('rewards', 'cumret'):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=HTML_ATOL)
    for f, w in zip(got['frames'], want['frames']):
        assert sorted(f) == sorted(w)
        for k in ('s', 'b', 'c'):
            np.testing.assert_allclose(np.asarray(f[k]), np.asarray(w[k]),
                                       rtol=0, atol=HTML_ATOL)


def test_port_replay_renders_end_to_end(replay, tmp_path):
    """tiny snapshot -> the port's sim_policy -> the port's PNG strip and
    HTML viewer, on the CPU."""
    png = str(tmp_path / 'strip.png')
    assert port_render.main([replay, '--env', 'half_cheetah', '--stride',
                             '5', '--device', 'cpu', '--out', png]) == png
    assert os.path.getsize(png) > 0
    html = port_viewer.main([replay, '--stride', '5', '--device', 'cpu',
                             '--out', str(tmp_path / 'view.html')])
    payload = _payload(html)
    assert len(payload['frames']) == len(payload['rewards']) == 4  # 20/5
    assert payload['frames'][0]['s'], 'no body segments serialized'
    page = open(html).read()
    for marker in ('requestAnimationFrame', 'onwheel', 'follow'):
        assert marker in page


_NO_JAX = r'''
import sys
for blocked in ('jax', 'jaxlib', 'learning_to_adapt_tpu', 'tools'):
    sys.modules[blocked] = None
import numpy as np
from learning_to_adapt_torch import interactive_viewer, render_trajectory
from learning_to_adapt_torch.envs.model_defs import get_model
npz, out = sys.argv[1], sys.argv[2]
frames = render_trajectory.render_frames(np.load(npz)['qpos'][0],
                                         get_model('half_cheetah'),
                                         stride=4, device='cpu')
html = interactive_viewer.export_html(npz, 'half_cheetah', stride=4,
                                      out=out, device='cpu')
loaded = sorted(m for m in sys.modules if m.split('.')[0] in (
    'jax', 'jaxlib', 'learning_to_adapt_tpu', 'tools')
    and sys.modules[m] is not None)
print('FRAMES', len(frames), 'LOADED', loaded)
'''


def test_renderer_needs_no_jax(replay, tmp_path):
    """Both modules import and render a port replay in a process where jax,
    the JAX package and tools/ cannot be imported."""
    out = str(tmp_path / 'nojax.html')
    env = dict(os.environ, PYTHONPATH=_REPO)
    res = subprocess.run([sys.executable, '-c', _NO_JAX, replay, out],
                         capture_output=True, text=True, env=env,
                         cwd=str(tmp_path), timeout=300)
    assert res.returncode == 0, res.stderr
    assert 'FRAMES 5 LOADED []' in res.stdout
    assert len(_payload(out)['frames']) == 5


@pytest.mark.cuda
def test_render_frames_on_the_card_match_the_cpu():
    """On a card: FK over the frames on the card against the CPU."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card')
    for name in MODELS:
        pm = port_model(name)
        qpos = _qpos_seq(pm, 40, seed=1)
        _assert_frames_close(
            port_render.render_frames(qpos, pm, stride=3, device='cuda'),
            port_render.render_frames(qpos, pm, stride=3, device='cpu'),
            ATOL)
