"""ctypes binding of the repository's native C++ physics oracle."""
from learning_to_adapt_torch.native.oracle import (  # noqa: F401
    KIND_CODES, NativePhysics, available, load_library)
