"""Base type semantics (reference: tests/basetypes.py + framework.h box math)."""

import fractions
import io

import pytest
import yaml

from canvas_tpu.basetypes import (box2i, box2f, box2i_intersect, box2i_union,
                                  box2i_normalize, register_yaml, rgba, v2i,
                                  v2f)


class TestV2i:
    def test_construct(self):
        assert v2i() == (0, 0)
        assert v2i(1, 2) == (1, 2)
        assert v2i((1, 2)) == (1, 2)
        assert v2i(1.9, 2.0) == (1, 2)

    def test_math(self):
        assert v2i(1, 2) + v2i(3, 4) == v2i(4, 6)
        assert v2i(1, 2) - v2i(3, 5) == v2i(-2, -3)
        assert -v2i(1, 2) == v2i(-1, -2)

    def test_repr(self):
        assert repr(v2i(1, 2)) == 'v2i(1, 2)'


class TestBox2i:
    def test_construct_forms(self):
        assert box2i().empty()
        assert box2i(0, 0, 3, 3) == box2i(v2i(0, 0), v2i(3, 3))
        assert box2i((0, 0), (3, 3)).max == v2i(3, 3)
        b = box2i(1, 2, 3, 4)
        assert box2i(b) == b

    def test_empty_convention(self):
        # Empty means max < min on either axis (framework.h:100-102)
        assert box2i(0, 0, -1, -1).empty()
        assert box2i(0, 0, -1, 5).empty()
        assert not box2i(0, 0, 0, 0).empty()
        assert bool(box2i(0, 0, 0, 0))

    def test_size(self):
        assert box2i(0, 0, 3, 2).size() == v2i(4, 3)
        assert box2i(0, 0, 3, 2).width == 4
        assert box2i(0, 0, 3, 2).height == 3
        assert box2i().size() == v2i(0, 0)

    def test_intersect_union(self):
        a = box2i(0, 0, 10, 10)
        b = box2i(5, 5, 15, 15)
        assert box2i_intersect(a, b) == box2i(5, 5, 10, 10)
        assert box2i_union(a, b) == box2i(0, 0, 15, 15)
        # disjoint boxes produce an empty (max < min) intersection
        c = box2i(20, 20, 30, 30)
        assert box2i_intersect(a, c).empty()

    def test_normalize(self):
        # framework.h:118-132: swapping keeps width: min = max+1, max = min-1
        assert box2i_normalize(box2i(5, 0, 2, 3)) == box2i(3, 0, 4, 3)
        assert box2i_normalize(box2i(0, 7, 3, 4)) == box2i(0, 5, 3, 6)

    def test_from_size_translate(self):
        assert box2i.from_size(2, 3, 4, 5) == box2i(2, 3, 5, 7)
        assert box2i(0, 0, 1, 1).translate(10, 20) == box2i(10, 20, 11, 21)


class TestRgba:
    def test_defaults(self):
        c = rgba(0.25, 0.5)
        assert c == (0.25, 0.5, 0.0, 1.0)
        assert c.a == 1.0


class TestYaml:
    @pytest.fixture(autouse=True)
    def _tags(self):
        register_yaml()

    def test_roundtrip(self):
        doc = {
            'pos': v2i(3, -4),
            'rect': box2i(0, 0, 719, 479),
            'float_rect': box2f(v2f(0.5, 0.5), v2f(1.5, 2.5)),
            'rate': fractions.Fraction(30000, 1001),
            'color': rgba(1.0, 0.5, 0.25, 1.0),
        }
        text = yaml.dump(doc)
        loaded = yaml.load(io.StringIO(text), Loader=yaml.FullLoader)
        assert loaded['pos'] == doc['pos']
        assert loaded['rect'] == doc['rect']
        assert loaded['float_rect'] == doc['float_rect']
        assert loaded['rate'] == doc['rate']
        assert loaded['color'] == doc['color']

    def test_tags_match_reference_format(self):
        # The reference writes '!v2i "(3, -4)"' style scalars and
        # '!box2i [...]' sequences; our files must interoperate.
        assert yaml.dump(v2i(3, -4)).strip() in ("!v2i '(3, -4)'", '!v2i (3, -4)')
        assert yaml.load('!v2i "(3, -4)"', Loader=yaml.FullLoader) == v2i(3, -4)
        loaded = yaml.load('!box2i [!v2i "(0, 0)", !v2i "(719, 479)"]',
                           Loader=yaml.FullLoader)
        assert loaded == box2i(0, 0, 719, 479)
        assert yaml.load('!rational [30000, 1001]', Loader=yaml.FullLoader) \
            == fractions.Fraction(30000, 1001)


def test_three_coordinate_box_raises():
    """box2i(0, 0, 3) is a typo for the 4-arg form; the old constructor
    silently discarded the third value and built (0,0)-(0,0)."""
    import pytest
    from canvas_tpu.basetypes import box2f
    with pytest.raises(TypeError):
        box2i(0, 0, 3)
    with pytest.raises(TypeError):
        box2f(0.0, 0.0, 3.0)
    assert box2i(0, 0, 3, 3).max == (3, 3)
