"""The model compiler and model definitions, frozen copies of the port's,
from which the reference's C++ physics (reference/oracle.py) takes the
model: the bodies, joints, geoms, masses and contact pairs, as a MuJoCo
XML file would give them."""
