"""Canvas: a JAX media processing framework.

A ground-up rebuild of the capabilities of fluggo/Canvas (a pull-based
video/audio engine + editor) with all pixel kernels on JAX/XLA.
See ARCHITECTURE.md and SURVEY.md at the repo root.
"""

NS_PER_SEC = 1000000000

from canvas_tpu.basetypes import (v2i, v2f, box2i, box2f, rgba)  # noqa: F401,E402

__version__ = '0.1.0'
