"""MJCF-subset XML loader (learning_to_adapt_tpu/physics/mjcf.py).

The feature subset the benchmark suite uses: compiler settotalmass/angle,
option timestep/gravity/integrator/iterations, one <default> class for
joint/geom/motor, nested worldbody trees with free/hinge/slide joints,
plane/hfield/sphere/capsule/box geoms (pos/quat/axisangle/fromto), motors
with gear/ctrlrange, <custom><numeric> init_qpos/frame_skip, and
<asset><hfield>.

Parses into the spec DSL (physics/spec.py), then compiles with
`compile_spec`, so XML models and programmatic models share one pipeline.
Host-side numpy only.
"""
import xml.etree.ElementTree as ET

import numpy as np

from learning_to_adapt_torch.physics.spec import (
    BOX, CAPSULE, EULER, FREE, HFIELD, HINGE, PLANE, RK4, SLIDE, SPHERE,
    ActuatorSpec, BodySpec, GeomSpec, HFieldSpec, JointSpec, ModelSpec,
    OptionSpec, compile_spec)

_GEOM_TYPES = {'plane': PLANE, 'hfield': HFIELD, 'sphere': SPHERE,
               'capsule': CAPSULE, 'box': BOX}
_JOINT_TYPES = {'free': FREE, 'hinge': HINGE, 'slide': SLIDE}
_INTEGRATORS = {'Euler': EULER, 'RK4': RK4}


def _floats(s):
    return tuple(float(x) for x in s.split())


def _get(elem, name, default=None, cast=str):
    v = elem.get(name)
    if v is None:
        return default
    if cast is str:
        return v
    if cast is float:
        return float(v)
    if cast is int:
        return int(v)
    if cast is bool:
        return v in ('true', '1')
    if cast is tuple:
        return _floats(v)
    raise ValueError(cast)


class _Defaults:
    def __init__(self, root):
        self.joint = {}
        self.geom = {}
        self.motor = {}
        d = root.find('default')
        if d is not None:
            j = d.find('joint')
            if j is not None:
                self.joint = dict(j.attrib)
            g = d.find('geom')
            if g is not None:
                self.geom = dict(g.attrib)
            m = d.find('motor')
            if m is not None:
                self.motor = dict(m.attrib)


def _merged(defaults, elem):
    out = dict(defaults)
    out.update(elem.attrib)
    return out


def load_mjcf(path=None, xml_string=None):
    """Parse MJCF into a compiled PhysicsModel."""
    if xml_string is not None:
        root = ET.fromstring(xml_string)
    else:
        root = ET.parse(path).getroot()

    compiler = root.find('compiler')
    angle_deg = (compiler is not None and
                 compiler.get('angle', 'degree') == 'degree')
    settotalmass = (None if compiler is None else
                    _get(compiler, 'settotalmass', None, float))
    ang = (np.pi / 180.0) if angle_deg else 1.0

    opt = OptionSpec()
    o = root.find('option')
    if o is not None:
        opt.timestep = _get(o, 'timestep', opt.timestep, float)
        opt.gravity = _get(o, 'gravity', opt.gravity, tuple)
        opt.integrator = _INTEGRATORS[_get(o, 'integrator', 'Euler')]
        opt.iterations = _get(o, 'iterations', opt.iterations, int)

    defaults = _Defaults(root)

    hfields = []
    asset = root.find('asset')
    if asset is not None:
        for hf in asset.findall('hfield'):
            size = _get(hf, 'size', (1, 1, 1, 0.1), tuple)
            nrow = _get(hf, 'nrow', 0, int)
            ncol = _get(hf, 'ncol', 0, int)
            if nrow == 0 or ncol == 0:
                # file-backed hfields: the tasks overwrite the data at
                # reset, so take the 528 x 500 grid of the terrain tasks
                nrow, ncol = 528, 500
            hfields.append(HFieldSpec(name=hf.get('name', 'hfield'),
                                      nrow=nrow, ncol=ncol, size=size))

    def parse_geom(elem):
        a = _merged(defaults.geom, elem)
        gtype = _GEOM_TYPES[a.get('type', 'sphere')]
        kw = dict(
            type=gtype,
            name=a.get('name', ''),
            size=_floats(a['size']) if 'size' in a else (),
            pos=_floats(a.get('pos', '0 0 0')),
            density=float(a.get('density', 1000.0)),
            friction=(_floats(a['friction']) if 'friction' in a
                      else (1.0, 0.005, 0.0001)),
            margin=float(a.get('margin', 0.0)),
            solref=(_floats(a['solref']) if 'solref' in a else (0.02, 1.0)),
            solimp=(_floats(a['solimp']) if 'solimp' in a
                    else (0.9, 0.95, 0.001)),
            condim=int(a.get('condim', 3)),
            contype=int(a.get('contype', 1)),
            conaffinity=int(a.get('conaffinity', 1)),
        )
        if 'mass' in a:
            kw['mass'] = float(a['mass'])
        if 'rgba' in a:
            kw['rgba'] = _floats(a['rgba'])
        if 'fromto' in a:
            kw['fromto'] = _floats(a['fromto'])
        elif 'axisangle' in a:
            ax = _floats(a['axisangle'])
            kw['axisangle'] = ax[:3] + (ax[3] * ang,)
        elif 'quat' in a:
            kw['quat'] = _floats(a['quat'])
        if 'hfield' in a:
            kw['hfield'] = a['hfield']
        return GeomSpec(**kw)

    def parse_joint(elem):
        a = _merged(defaults.joint, elem)
        jtype = _JOINT_TYPES[a.get('type', 'hinge')]
        rng = _floats(a.get('range', '0 0'))
        return JointSpec(
            type=jtype,
            name=a.get('name', ''),
            pos=_floats(a.get('pos', '0 0 0')),
            axis=_floats(a.get('axis', '0 0 1')),
            range=(rng[0] * ang, rng[1] * ang) if jtype == HINGE else rng,
            limited=a.get('limited', 'false') in ('true', '1'),
            damping=float(a.get('damping', 0.0)),
            armature=float(a.get('armature', 0.0)),
            stiffness=float(a.get('stiffness', 0.0)),
            springref=float(a.get('springref', 0.0)) * (
                ang if jtype == HINGE else 1.0),
            ref=float(a.get('ref', 0.0)) * (ang if jtype == HINGE else 1.0),
            solref_limit=(_floats(a['solreflimit']) if 'solreflimit' in a
                          else (0.02, 1.0)),
            solimp_limit=(_floats(a['solimplimit']) if 'solimplimit' in a
                          else (0.9, 0.95, 0.001)),
        )

    def parse_body(elem):
        b = BodySpec(
            name=elem.get('name', ''),
            pos=_floats(elem.get('pos', '0 0 0')),
            quat=_floats(elem.get('quat', '1 0 0 0')),
        )
        for child in elem:
            if child.tag == 'joint':
                b.joints.append(parse_joint(child))
            elif child.tag == 'geom':
                b.geoms.append(parse_geom(child))
            elif child.tag == 'body':
                b.children.append(parse_body(child))
        return b

    world = root.find('worldbody')
    world_geoms, bodies = [], []
    for child in world:
        if child.tag == 'geom':
            world_geoms.append(parse_geom(child))
        elif child.tag == 'body':
            bodies.append(parse_body(child))

    actuators = []
    act = root.find('actuator')
    if act is not None:
        for motor in act.findall('motor'):
            a = _merged(defaults.motor, motor)
            actuators.append(ActuatorSpec(
                joint=a['joint'],
                gear=float(a.get('gear', 1.0)),
                ctrlrange=(_floats(a['ctrlrange']) if 'ctrlrange' in a
                           else (-1.0, 1.0)),
                name=a.get('name', '')))

    init_qpos = None
    frame_skip = 1
    custom = root.find('custom')
    if custom is not None:
        for num in custom.findall('numeric'):
            if num.get('name') == 'init_qpos':
                init_qpos = _floats(num.get('data'))
            elif num.get('name') == 'frame_skip':
                frame_skip = int(float(num.get('data')))

    spec = ModelSpec(
        name=root.get('model', 'mjcf'),
        option=opt,
        world_geoms=world_geoms,
        bodies=bodies,
        actuators=actuators,
        hfields=hfields,
        settotalmass=settotalmass,
        init_qpos=init_qpos,
        frame_skip=frame_skip,
    )
    return compile_spec(spec)
