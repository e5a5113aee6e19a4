"""Geometry and color base types.

Port of the reference's base types: the C structs in
include/framework.h:46-149 and the Python namedtuples + YAML tags in
fluggo/media/basetypes.py:24-201. Semantics match the
reference exactly (empty-box convention ``max < min``, inclusive box bounds),
but the implementation is original.
"""

import collections
import fractions

# 'fractions' is deliberately exported: the reference's basetypes module
# has no __all__, so its `import fractions` leaks into star-imports, and
# client code relies on it (e.g. /root/reference/tests/canvas/
# ItemManipulator.py:8 uses `fractions.Fraction` after
# `from fluggo.media.basetypes import *`).
__all__ = ['v2i', 'v2f', 'box2i', 'box2f', 'rgba',
           'box2i_intersect', 'box2i_union', 'box2i_normalize',
           'fractions']


_v2i_base = collections.namedtuple('_v2i_base', 'x y')


class v2i(_v2i_base):
    """Integer 2-vector. Accepts v2i(x, y) or v2i((x, y))."""
    __slots__ = ()

    def __new__(cls, x=0, y=0):
        if isinstance(x, tuple):
            x, y = x
        return _v2i_base.__new__(cls, int(x), int(y))

    def __add__(self, other):
        return v2i(self[0] + other[0], self[1] + other[1])

    def __sub__(self, other):
        return v2i(self[0] - other[0], self[1] - other[1])

    def __neg__(self):
        return v2i(-self[0], -self[1])

    def __repr__(self):
        return 'v2i({0.x!r}, {0.y!r})'.format(self)


_v2f_base = collections.namedtuple('_v2f_base', 'x y')


class v2f(_v2f_base):
    """Float 2-vector."""
    __slots__ = ()

    def __new__(cls, x=0, y=0):
        if isinstance(x, tuple):
            x, y = x
        return _v2f_base.__new__(cls, float(x), float(y))

    def __add__(self, other):
        return v2f(self[0] + other[0], self[1] + other[1])

    def __sub__(self, other):
        return v2f(self[0] - other[0], self[1] - other[1])

    def __neg__(self):
        return v2f(-self[0], -self[1])

    def __repr__(self):
        return 'v2f({0.x!r}, {0.y!r})'.format(self)


_box2i_base = collections.namedtuple('_box2i_base', 'min max')


class box2i(_box2i_base):
    """Integer box with *inclusive* min/max corners.

    A box is empty when ``max.x < min.x`` or ``max.y < min.y`` (the
    reference's convention, framework.h:96-102). Accepts::

        box2i()                      # empty
        box2i(v2i(0, 0), v2i(3, 3))
        box2i((0, 0), (3, 3))
        box2i(0, 0, 3, 3)            # min_x, min_y, max_x, max_y
        box2i(other_box)
    """
    __slots__ = ()

    def __new__(cls, min=v2i(0, 0), max=v2i(-1, -1), max_x=None, max_y=None):
        if max_x is not None and max_y is not None:
            min = v2i(min, max)
            max = v2i(max_x, max_y)
        elif (max_x is None) != (max_y is None):
            # three positional args would otherwise silently discard
            # the third and build a (0,0)-(0,0) box
            raise TypeError('box2i takes 0, 1, 2 or 4 coordinates')
        elif isinstance(min, box2i):
            min, max = min
        return _box2i_base.__new__(cls, v2i(min), v2i(max))

    @classmethod
    def from_size(cls, x, y, width, height):
        return cls(x, y, x + width - 1, y + height - 1)

    @property
    def width(self):
        return max(0, self.max.x - self.min.x + 1)

    @property
    def height(self):
        return max(0, self.max.y - self.min.y + 1)

    def size(self):
        if self.empty():
            return v2i()
        return v2i(self.max.x - self.min.x + 1, self.max.y - self.min.y + 1)

    def empty(self):
        return not bool(self)

    def __bool__(self):
        return self.max.x >= self.min.x and self.max.y >= self.min.y

    def intersect(self, other):
        return box2i_intersect(self, other)

    def union(self, other):
        return box2i_union(self, other)

    def contains_point(self, x, y):
        return (self.min.x <= x <= self.max.x) and (self.min.y <= y <= self.max.y)

    def translate(self, dx, dy):
        return box2i(self.min.x + dx, self.min.y + dy,
                     self.max.x + dx, self.max.y + dy)

    def __repr__(self):
        return 'box2i({0.min!r}, {0.max!r})'.format(self)


_box2f_base = collections.namedtuple('_box2f_base', 'min max')


class box2f(_box2f_base):
    """Float box; empty when max < min on either axis."""
    __slots__ = ()

    def __new__(cls, min=v2f(0, 0), max=v2f(-1, -1), max_x=None, max_y=None):
        if max_x is not None and max_y is not None:
            min = v2f(min, max)
            max = v2f(max_x, max_y)
        elif (max_x is None) != (max_y is None):
            raise TypeError('box2f takes 0, 1, 2 or 4 coordinates')
        elif isinstance(min, box2f):
            min, max = min
        return _box2f_base.__new__(cls, v2f(min), v2f(max))

    def width(self):
        return max(0.0, self.max.x - self.min.x)

    def height(self):
        return max(0.0, self.max.y - self.min.y)

    def size(self):
        if self.empty():
            return v2f()
        return self.max - self.min

    def empty(self):
        return not bool(self)

    def __bool__(self):
        return self.max.x >= self.min.x and self.max.y >= self.min.y

    def __repr__(self):
        return 'box2f({0.min!r}, {0.max!r})'.format(self)


_rgba_base = collections.namedtuple('_rgba_base', 'r g b a')


class rgba(_rgba_base):
    """Float RGBA color (unassociated alpha in storage; see ops.mix)."""
    __slots__ = ()

    def __new__(cls, r=0.0, g=0.0, b=0.0, a=1.0):
        return _rgba_base.__new__(cls, float(r), float(g), float(b), float(a))

    def __repr__(self):
        return 'rgba({0.r:.6}, {0.g:.6}, {0.b:.6}, {0.a:.6})'.format(self)


EMPTY_BOX2I = box2i(0, 0, -1, -1)

# "Infinite" box used by sources with no inherent bounds (the reference uses
# INT_MIN/INT_MAX, SolidColorVideoSource.c:41-44). Kept comfortably away from
# int32 limits so translations can't overflow.
INFINITE_BOX2I = box2i(-2 ** 30, -2 ** 30, 2 ** 30, 2 ** 30)


def box2i_intersect(a, b):
    """Intersection; may produce an empty (max < min) box."""
    return box2i(max(a.min.x, b.min.x), max(a.min.y, b.min.y),
                 min(a.max.x, b.max.x), min(a.max.y, b.max.y))


def box2i_union(a, b):
    return box2i(min(a.min.x, b.min.x), min(a.min.y, b.min.y),
                 max(a.max.x, b.max.x), max(a.max.y, b.max.y))


def box2i_normalize(b):
    """Swap each axis where min > max (framework.h:118-132)."""
    min_x, max_x = b.min.x, b.max.x
    min_y, max_y = b.min.y, b.max.y
    if min_x > max_x:
        min_x, max_x = max_x + 1, min_x - 1
    if min_y > max_y:
        min_y, max_y = max_y + 1, min_y - 1
    return box2i(min_x, min_y, max_x, max_y)


# --- YAML tags (format-compatible with the reference's project files) -------

def _rational_represent(dumper, data):
    return dumper.represent_sequence('!rational', [data.numerator, data.denominator])


def _rational_construct(loader, node):
    return fractions.Fraction(*loader.construct_sequence(node))


def _v2i_represent(dumper, data):
    return dumper.represent_scalar('!v2i', '({0}, {1})'.format(data.x, data.y))


def _v2i_construct(loader, node):
    value = loader.construct_scalar(node)
    x, y = value.strip()[1:-1].split(',')
    return v2i(int(x), int(y))


def _v2f_represent(dumper, data):
    return dumper.represent_scalar('!v2f', '({0!r}, {1!r})'.format(data.x, data.y))


def _v2f_construct(loader, node):
    value = loader.construct_scalar(node)
    x, y = value.strip()[1:-1].split(',')
    return v2f(float(x), float(y))


def _box2i_represent(dumper, data):
    return dumper.represent_sequence('!box2i', [data.min, data.max])


def _box2i_construct(loader, node):
    return box2i(*loader.construct_sequence(node))


def _box2f_represent(dumper, data):
    return dumper.represent_sequence('!box2f', [data.min, data.max])


def _box2f_construct(loader, node):
    return box2f(*loader.construct_sequence(node))


def _rgba_represent(dumper, data):
    return dumper.represent_sequence('!rgba', list(data))


def _rgba_construct(loader, node):
    return rgba(*loader.construct_sequence(node))


_yaml_registered = False


def register_yaml(loader_cls=None, dumper_cls=None):
    """Register all tags on the given classes (defaults: global pyyaml).

    Called by the modules that read or write YAML (the editor's model,
    plugins and app), so that the render path never imports yaml. The
    default global registration runs once."""
    global _yaml_registered
    import yaml

    if loader_cls is None and dumper_cls is None:
        if _yaml_registered:
            return
        _yaml_registered = True
    pairs = [
        (fractions.Fraction, '!rational', _rational_represent, _rational_construct),
        (v2i, '!v2i', _v2i_represent, _v2i_construct),
        (v2f, '!v2f', _v2f_represent, _v2f_construct),
        (box2i, '!box2i', _box2i_represent, _box2i_construct),
        (box2f, '!box2f', _box2f_represent, _box2f_construct),
        (rgba, '!rgba', _rgba_represent, _rgba_construct),
    ]
    for cls, tag, rep, con in pairs:
        if dumper_cls is not None:
            yaml.add_representer(cls, rep, Dumper=dumper_cls)
        else:
            yaml.add_representer(cls, rep)
        if loader_cls is not None:
            yaml.add_constructor(tag, con, Loader=loader_cls)
        else:
            yaml.add_constructor(tag, con)
            # pyyaml's add_constructor default only covers Loader/FullLoader
            # in some versions; make SafeLoader work too.
            yaml.add_constructor(tag, con, Loader=yaml.SafeLoader)
