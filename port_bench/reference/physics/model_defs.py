# Frozen copy of learning_to_adapt_torch/envs/model_defs.py at commit
# 0fd707d, kept as the benchmark's plain reference: it is not edited with the
# program. Its imports point at this folder.
"""Programmatic model definitions.

The specs of the five environments (HalfCheetah, its terrain and blocks
variants, the Ant, the 7-DoF arm), transcribed from the same model facts
as learning_to_adapt_tpu/envs/model_defs.py (masses, lengths, gains).
"""
import numpy as np

from .spec import (
    BOX, CAPSULE, EULER, FREE, HFIELD, HINGE, PLANE, RK4, SLIDE, SPHERE,
    ActuatorSpec, BodySpec, GeomSpec, HFieldSpec, JointSpec, ModelSpec,
    OptionSpec, compile_spec)

DEG = np.pi / 180.0


# ---------------------------------------------------------------------------
# half cheetah
# ---------------------------------------------------------------------------

def _cheetah_geom(**kw):
    """Cheetah geom defaults: contype 1, conaffinity 0, condim 3,
    friction (.4,.1,.1), solref (.02,1), solimp (0,.8,.01)."""
    base = dict(type=CAPSULE, contype=1, conaffinity=0, condim=3,
                friction=(0.4, 0.1, 0.1), solref=(0.02, 1.0),
                solimp=(0.0, 0.8, 0.01), density=1000.0)
    base.update(kw)
    return GeomSpec(**base)


def _cheetah_joint(**kw):
    """Cheetah leg-joint defaults: limited, armature .1, solreflimit (.02,1),
    solimplimit (0,.8,.03)."""
    base = dict(type=HINGE, axis=(0, 1, 0), limited=True, armature=0.1,
                solref_limit=(0.02, 1.0), solimp_limit=(0.0, 0.8, 0.03))
    base.update(kw)
    return JointSpec(**base)


def _cheetah_tree(torso_z=0.7):
    """The cheetah body tree shared by the three cheetah environments; the
    terrain variant spawns higher (torso z = 1)."""
    bfoot = BodySpec(
        name='bfoot', pos=(-.28, 0, -.14),
        joints=[_cheetah_joint(name='bfoot', range=(-.4, .785),
                               stiffness=120., damping=3.)],
        geoms=[_cheetah_geom(name='bfoot', pos=(.03, 0, -.097),
                             axisangle=(0, 1, 0, -.27), size=(.046, .094))])
    bshin = BodySpec(
        name='bshin', pos=(.16, 0, -.25),
        joints=[_cheetah_joint(name='bshin', range=(-.785, .785),
                               stiffness=180., damping=4.5)],
        geoms=[_cheetah_geom(name='bshin', pos=(-.14, 0, -.07),
                             axisangle=(0, 1, 0, -2.03), size=(.046, .15))],
        children=[bfoot])
    bthigh = BodySpec(
        name='bthigh', pos=(-.5, 0, 0),
        joints=[_cheetah_joint(name='bthigh', range=(-.52, 1.05),
                               stiffness=240., damping=6.)],
        geoms=[_cheetah_geom(name='bthigh', pos=(.1, 0, -.13),
                             axisangle=(0, 1, 0, -3.8), size=(.046, .145))],
        children=[bshin])
    ffoot = BodySpec(
        name='ffoot', pos=(.13, 0, -.18),
        joints=[_cheetah_joint(name='ffoot', range=(-.5, .5),
                               stiffness=60., damping=1.5)],
        geoms=[_cheetah_geom(name='ffoot', pos=(.045, 0, -.07),
                             axisangle=(0, 1, 0, -.6), size=(.046, .07))])
    fshin = BodySpec(
        name='fshin', pos=(-.14, 0, -.24),
        joints=[_cheetah_joint(name='fshin', range=(-1.2, .87),
                               stiffness=120., damping=3.)],
        geoms=[_cheetah_geom(name='fshin', pos=(.065, 0, -.09),
                             axisangle=(0, 1, 0, -.6), size=(.046, .106))],
        children=[ffoot])
    fthigh = BodySpec(
        name='fthigh', pos=(.5, 0, 0),
        joints=[_cheetah_joint(name='fthigh', range=(-1, .7),
                               stiffness=180., damping=4.5)],
        geoms=[_cheetah_geom(name='fthigh', pos=(-.07, 0, -.12),
                             axisangle=(0, 1, 0, .52), size=(.046, .133))],
        children=[fshin])
    torso = BodySpec(
        name='torso', pos=(0, 0, torso_z),
        joints=[
            JointSpec(type=SLIDE, name='rootx', axis=(1, 0, 0)),
            JointSpec(type=SLIDE, name='rootz', axis=(0, 0, 1)),
            JointSpec(type=HINGE, name='rooty', axis=(0, 1, 0)),
        ],
        geoms=[
            _cheetah_geom(name='torso', fromto=(-.5, 0, 0, .5, 0, 0),
                          size=(0.046,)),
            _cheetah_geom(name='head', pos=(.6, 0, .1),
                          axisangle=(0, 1, 0, .87), size=(0.046, .15)),
        ],
        children=[bthigh, fthigh])
    return torso


def _cheetah_actuators():
    return [ActuatorSpec(joint='bthigh', gear=120, ctrlrange=(-1, 1)),
            ActuatorSpec(joint='bshin', gear=90, ctrlrange=(-1, 1)),
            ActuatorSpec(joint='bfoot', gear=60, ctrlrange=(-1, 1)),
            ActuatorSpec(joint='fthigh', gear=120, ctrlrange=(-1, 1)),
            ActuatorSpec(joint='fshin', gear=60, ctrlrange=(-1, 1)),
            ActuatorSpec(joint='ffoot', gear=30, ctrlrange=(-1, 1))]


def half_cheetah_spec() -> ModelSpec:
    floor = GeomSpec(type=PLANE, name='floor', size=(40, 40, 40), contype=1,
                     conaffinity=1, condim=3, friction=(0.4, 0.1, 0.1),
                     solref=(0.02, 1.0), solimp=(0.0, 0.8, 0.01))
    return ModelSpec(
        name='half_cheetah',
        option=OptionSpec(timestep=0.01, gravity=(0, 0, -9.81),
                          integrator=EULER),
        world_geoms=[floor],
        bodies=[_cheetah_tree()],
        actuators=_cheetah_actuators(),
        settotalmass=14.0)


def half_cheetah_hfield_spec() -> ModelSpec:
    """Cheetah on a procedural heightfield; the terrain profile is runtime
    data (MutableModel.hfield_row / hfield_size), on a 528 x 500 grid
    (profile along x, constant along y)."""
    floor = GeomSpec(type=HFIELD, name='floor', pos=(0, 0, 0), contype=1,
                     conaffinity=1, condim=3, friction=(0.4, 0.1, 0.1),
                     solref=(0.02, 1.0), solimp=(0.0, 0.8, 0.01),
                     hfield='floor')
    return ModelSpec(
        name='half_cheetah_hfield',
        option=OptionSpec(timestep=0.01, gravity=(0, 0, -9.81),
                          integrator=EULER),
        world_geoms=[floor],
        bodies=[_cheetah_tree(torso_z=1.0)],
        actuators=_cheetah_actuators(),
        hfields=[HFieldSpec(name='floor', nrow=528, ncol=500,
                            size=(10, 10, 0.1, 0.1))],
        settotalmass=14.0)


def half_cheetah_blocks_spec() -> ModelSpec:
    """Cheetah walking over 8 spring-loaded blocks (the 'damping' task
    randomizes the first 8 dof dampings)."""
    blocks = []
    layout = [(-8.0, 5.999), (0.0, 1.999), (4.0, 1.999), (8.0, 1.999),
              (12.0, 1.999), (16.0, 1.999), (20.0, 1.999), (42.0, 19.999)]
    for i, (x, w) in enumerate(layout):
        blocks.append(BodySpec(
            name=f'block_{i}', pos=(x, 0, 0.05),
            joints=[JointSpec(type=SLIDE, name=f'blockz_{i}', axis=(0, 0, 1),
                              limited=True, range=(-.15, .15), stiffness=150.,
                              springref=0., damping=.01, armature=.1,
                              solref_limit=(0.02, 1.0),
                              solimp_limit=(0.0, 0.8, 0.03))],
            geoms=[GeomSpec(type=BOX, name=f'block_{i}', size=(w, .99, 0.05),
                            mass=10., contype=1, conaffinity=1, condim=3,
                            friction=(0.4, 0.1, 0.1), solref=(0.02, 1.0),
                            solimp=(0.0, 0.8, 0.01))]))
    floor = GeomSpec(type=PLANE, name='floor', pos=(0, 0, -.1),
                     size=(40, 40, 40), contype=0, conaffinity=0, condim=3)
    return ModelSpec(
        name='half_cheetah_blocks',
        option=OptionSpec(timestep=0.01, gravity=(0, 0, -9.81),
                          integrator=EULER),
        world_geoms=[floor],
        bodies=blocks + [_cheetah_tree()],
        actuators=_cheetah_actuators(),
        settotalmass=14.0)


# ---------------------------------------------------------------------------
# ant
# ---------------------------------------------------------------------------

def _ant_geom(**kw):
    base = dict(type=CAPSULE, condim=3, contype=1, conaffinity=0,
                margin=0.01, friction=(1.0, 0.5, 0.5), solref=(.02, 1.),
                solimp=(.8, .8, .01), density=5.0)
    base.update(kw)
    return GeomSpec(**base)


def _ant_joint(**kw):
    base = dict(type=HINGE, limited=True, armature=1.0, damping=1.0)
    base.update(kw)
    return JointSpec(**base)


def ant_spec() -> ModelSpec:
    def leg(idx, sx, sy, hip_name, ankle_name, ankle_axis, ankle_range_deg,
            geom_names):
        """One ant leg: aux geom on a welded shoulder body, hip + ankle."""
        foot = BodySpec(
            name=f'foot_{idx}', pos=(sx * 0.2, sy * 0.2, 0),
            joints=[_ant_joint(name=ankle_name, axis=ankle_axis,
                               range=(ankle_range_deg[0] * DEG,
                                      ankle_range_deg[1] * DEG))],
            geoms=[_ant_geom(name=geom_names[2], size=(0.08,),
                             fromto=(0, 0, 0, sx * 0.4, sy * 0.4, 0))])
        shin = BodySpec(
            name=f'aux_{idx}', pos=(sx * 0.2, sy * 0.2, 0),
            joints=[_ant_joint(name=hip_name, axis=(0, 0, 1),
                               range=(-30 * DEG, 30 * DEG))],
            geoms=[_ant_geom(name=geom_names[1], size=(0.08,),
                             fromto=(0, 0, 0, sx * 0.2, sy * 0.2, 0))],
            children=[foot])
        return BodySpec(
            name=f'leg_{idx}', pos=(0, 0, 0),
            geoms=[_ant_geom(name=geom_names[0], size=(0.08,),
                             fromto=(0, 0, 0, sx * 0.2, sy * 0.2, 0))],
            children=[shin])

    torso = BodySpec(
        name='torso', pos=(0, 0, 0.75),
        joints=[JointSpec(type=FREE, name='root')],
        geoms=[_ant_geom(name='torso_geom', type=SPHERE, size=(0.25,))],
        children=[
            leg(1, 1, 1, 'hip_1', 'ankle_1', (-1, 1, 0), (30, 70),
                ('aux_1_geom', 'left_leg_geom', 'left_ankle_geom')),
            leg(2, -1, 1, 'hip_2', 'ankle_2', (1, 1, 0), (-70, -30),
                ('aux_2_geom', 'right_leg_geom', 'right_ankle_geom')),
            leg(3, -1, -1, 'hip_3', 'ankle_3', (-1, 1, 0), (-70, -30),
                ('aux_3_geom', 'back_leg_geom', 'third_ankle_geom')),
            leg(4, 1, -1, 'hip_4', 'ankle_4', (1, 1, 0), (30, 70),
                ('aux_4_geom', 'rightback_leg_geom', 'fourth_ankle_geom')),
        ])
    floor = GeomSpec(type=PLANE, name='floor', size=(40, 40, 40), contype=1,
                     conaffinity=1, condim=3, margin=0.01,
                     friction=(1.0, 0.5, 0.5), solref=(.02, 1.),
                     solimp=(.8, .8, .01))
    acts = [ActuatorSpec(joint=j, gear=1.0, ctrlrange=(-150., 150.))
            for j in ('hip_4', 'ankle_4', 'hip_1', 'ankle_1',
                      'hip_2', 'ankle_2', 'hip_3', 'ankle_3')]
    return ModelSpec(
        name='ant',
        option=OptionSpec(timestep=0.02, gravity=(0, 0, -9.81),
                          integrator=RK4),
        world_geoms=[floor],
        bodies=[torso],
        actuators=acts,
        init_qpos=(0.0, 0.0, 0.55, 1.0, 0.0, 0.0, 0.0,
                   0.0, 1.0, 0.0, -1.0, 0.0, -1.0, 0.0, 1.0))


# ---------------------------------------------------------------------------
# 7-dof arm
# ---------------------------------------------------------------------------

def _arm_geom(**kw):
    base = dict(type=CAPSULE, friction=(.5, .1, .1), margin=0.002, condim=1,
                contype=0, conaffinity=0, density=1000.0)
    base.update(kw)
    return GeomSpec(**base)


def _arm_joint(**kw):
    base = dict(type=HINGE, limited=True, armature=0.04, damping=1.0)
    base.update(kw)
    return JointSpec(**base)


def arm_7dof_spec() -> ModelSpec:
    obj = BodySpec(
        name='object', pos=(.15, 0, 0),
        geoms=[GeomSpec(type=BOX, name='object', size=(.05, .05, .025),
                        contype=1, conaffinity=1, condim=1,
                        friction=(.5, .1, .1), margin=0.002)])
    palm = BodySpec(
        name='r_gripper_palm_link',
        geoms=[_arm_geom(name='pl', fromto=(.05, 0, -.02, .05, 0, .02),
                         size=(.05,))],
        children=[obj])
    wrist_roll = BodySpec(
        name='r_wrist_roll_link',
        joints=[_arm_joint(name='r_wrist_roll_joint', axis=(1, 0, 0),
                           range=(-3.15, 3.15), damping=0.1)],
        geoms=[_arm_geom(name='wr', fromto=(-.02, 0, 0, .02, 0, 0),
                         size=(.01,))],
        children=[palm])
    wrist_flex = BodySpec(
        name='r_wrist_flex_link', pos=(.321, 0, 0),
        joints=[_arm_joint(name='r_wrist_flex_joint', axis=(0, 1, 0),
                           range=(-2.094, 0), damping=.1)],
        geoms=[_arm_geom(name='wf', fromto=(0, -.02, 0, 0, .02, 0),
                         size=(.01,))],
        children=[wrist_roll])
    forearm = BodySpec(
        name='r_forearm_link',
        geoms=[_arm_geom(name='fa', fromto=(0, 0, 0, .321, 0, 0), size=(.05,),
                         contype=1, conaffinity=1)],
        children=[wrist_flex])
    forearm_roll = BodySpec(
        name='r_forearm_roll_link',
        joints=[_arm_joint(name='r_forearm_roll_joint', axis=(1, 0, 0),
                           range=(-3.15, 3.15), damping=.1)],
        geoms=[_arm_geom(name='fr', fromto=(-.1, 0, 0, .1, 0, 0),
                         size=(.02,))],
        children=[forearm])
    elbow = BodySpec(
        name='r_elbow_flex_link', pos=(.4, 0, 0),
        joints=[_arm_joint(name='r_elbow_flex_joint', axis=(0, 1, 0),
                           range=(-2.3213, 0), damping=1.0)],
        geoms=[_arm_geom(name='ef', fromto=(0, -.02, 0, 0, .02, 0),
                         size=(.06,))],
        children=[forearm_roll])
    upper_arm = BodySpec(
        name='r_upper_arm_link',
        geoms=[_arm_geom(name='ua', fromto=(0, 0, 0, .4, 0, 0), size=(.06,),
                         contype=1, conaffinity=1)],
        children=[elbow])
    upper_arm_roll = BodySpec(
        name='r_upper_arm_roll_link',
        joints=[_arm_joint(name='r_upper_arm_roll_joint', axis=(1, 0, 0),
                           range=(-3.9, 0.8), damping=0.1)],
        geoms=[_arm_geom(name='uar', fromto=(-.1, 0, 0, .1, 0, 0),
                         size=(.02,))],
        children=[upper_arm])
    shoulder_lift = BodySpec(
        name='r_shoulder_lift_link', pos=(0.1, 0, 0),
        joints=[_arm_joint(name='r_shoulder_lift_joint', axis=(0, 1, 0),
                           range=(-.5236, 1.3963), damping=10.0)],
        geoms=[_arm_geom(name='sl', fromto=(0, -.1, 0, 0, .1, 0), size=(.1,),
                         contype=1, conaffinity=1)],
        children=[upper_arm_roll])
    shoulder_pan = BodySpec(
        name='r_shoulder_pan_link', pos=(0, -0.188, 0),
        joints=[_arm_joint(name='r_shoulder_pan_joint', axis=(0, 0, 1),
                           range=(-2.2854, 1.714602), damping=10.0)],
        geoms=[
            _arm_geom(name='e1', type=SPHERE, pos=(-.06, .05, .2),
                      size=(.05,)),
            _arm_geom(name='e2', type=SPHERE, pos=(.06, .05, .2), size=(.05,)),
            _arm_geom(name='e1p', type=SPHERE, pos=(-.06, .09, .2),
                      size=(.03,)),
            _arm_geom(name='e2p', type=SPHERE, pos=(.06, .09, .2),
                      size=(.03,)),
            _arm_geom(name='sp', fromto=(0, 0, -0.4, 0, 0, 0.2), size=(.1,),
                      contype=1, conaffinity=1),
        ],
        children=[shoulder_lift])
    target = BodySpec(
        name='target', pos=(0, 0, 0),
        joints=[
            JointSpec(type=SLIDE, name='target_x', axis=(1, 0, 0), ref=.1),
            JointSpec(type=SLIDE, name='target_y', axis=(0, 1, 0), ref=-.1),
            JointSpec(type=SLIDE, name='target_z', axis=(0, 0, 1), ref=-.1),
        ],
        geoms=[GeomSpec(type=SPHERE, name='target', size=(.02,), contype=0,
                        conaffinity=0)])
    floor = GeomSpec(type=PLANE, name='floor', pos=(0, 0, -1),
                     size=(40, 40, 40), contype=0, conaffinity=0, condim=3)
    acts = [ActuatorSpec(joint=f'r_{n}_joint', gear=1.0, ctrlrange=(-1., 1.))
            for n in ('shoulder_pan', 'shoulder_lift', 'upper_arm_roll',
                      'elbow_flex', 'forearm_roll', 'wrist_flex',
                      'wrist_roll')]
    return ModelSpec(
        name='arm_7dof',
        option=OptionSpec(timestep=0.02, gravity=(0, 0, 0), integrator=EULER,
                          iterations=20),
        world_geoms=[floor],
        bodies=[shoulder_pan, target],
        actuators=acts)


_SPEC_FNS = {
    'half_cheetah': half_cheetah_spec,
    'half_cheetah_hfield': half_cheetah_hfield_spec,
    'half_cheetah_blocks': half_cheetah_blocks_spec,
    'ant': ant_spec,
    'arm_7dof': arm_7dof_spec,
}

_MODEL_CACHE = {}


def get_model(name):
    """Compiled PhysicsModel by env name (cached: compile once per process)."""
    if name not in _MODEL_CACHE:
        _MODEL_CACHE[name] = compile_spec(_SPEC_FNS[name]())
    return _MODEL_CACHE[name]
