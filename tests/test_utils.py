"""Signal / EZList / SortedList / logging utilities."""

import gc
import os

import pytest

from canvas_tpu.ezlist import EZList
from canvas_tpu.signal import Signal
from canvas_tpu.sortlist import AutoIndexList, SortedList


class Receiver:
    def __init__(self):
        self.calls = []

    def on_event(self, *args, **kwargs):
        self.calls.append((args, kwargs))


class TestSignal:
    def test_fire(self):
        sig = Signal()
        r = Receiver()
        sig.connect(r.on_event)
        sig(1, a=2)
        assert r.calls == [((1,), {'a': 2})]

    def test_disconnect(self):
        sig = Signal()
        r = Receiver()
        sig.connect(r.on_event)
        sig.disconnect(r.on_event)
        sig()
        assert r.calls == []

    def test_weakref_cleanup(self):
        sig = Signal()
        r = Receiver()
        sig.connect(r.on_event)
        del r
        gc.collect()
        sig()  # must not raise or call into a dead object
        assert len(sig) == 0

    def test_plain_function(self):
        sig = Signal()
        calls = []
        def f(x):
            calls.append(x)
        sig.connect(f)
        sig(5)
        assert calls == [5]


class SimpleEZ(EZList):
    def __init__(self, items=()):
        EZList.__init__(self)
        self._list = list(items)

    def _replace_range(self, start, stop, items):
        self._list[start:stop] = items
        self._update_marks(start, stop, len(items))

    def __getitem__(self, i):
        return self._list[i]

    def __len__(self):
        return len(self._list)


class TestEZList:
    def test_mutations(self):
        lst = SimpleEZ([1, 2, 3])
        lst.insert(1, 10)
        assert list(lst) == [1, 10, 2, 3]
        lst[0] = 99
        assert list(lst) == [99, 10, 2, 3]
        del lst[1]
        assert list(lst) == [99, 2, 3]
        lst[1:3] = [7]
        assert list(lst) == [99, 7]

    def test_marks_gravity(self):
        lst = SimpleEZ([0, 1, 2, 3, 4])
        left = lst.create_mark(2, True)
        right = lst.create_mark(2, False)

        # Insert before the marks: both slide right
        lst.insert(0, 99)
        assert left.index == 3 and right.index == 3

        # Replace a range spanning the marks: left sticks to start,
        # right moves to end of the inserted run
        lst[2:4] = [7, 8, 9]
        assert left.index == 2
        assert right.index == 5

    def test_mark_arithmetic(self):
        lst = SimpleEZ([0, 1, 2])
        m = lst.create_mark(1, True)
        assert m + 1 == 2
        assert 3 - m == 2
        assert m < 2
        assert m == 1
        assert lst[m] == 1


class Indexed:
    pass


class TestAutoIndexList:
    def test_index_attr(self):
        items = [Indexed() for _ in range(3)]
        lst = AutoIndexList(items, index_attr='idx')
        assert [it.idx for it in lst] == [0, 1, 2]
        new = Indexed()
        lst.insert(1, new)
        assert new.idx == 1
        assert items[1].idx == 2
        assert lst.index(items[2]) == 3


class TestSortedList:
    def test_sorted_add(self):
        sl = SortedList([5, 1, 3])
        sl.add(2)
        assert list(sl) == [1, 2, 3, 5]

    def test_keyfunc_and_move(self):
        class Item:
            def __init__(self, key):
                self.key = key
            def __repr__(self):
                return 'Item(%r)' % self.key

        a, b, c = Item(1), Item(5), Item(3)
        # index_attr keeps index() valid even after an item's key changes
        sl = SortedList([a, b, c], keyfunc=lambda it: it.key, index_attr='idx')
        assert list(sl) == [a, c, b]
        c.key = 9
        sl.move(sl.index(c))
        assert list(sl) == [a, b, c]
        assert [it.idx for it in (a, b, c)] == [0, 1, 2]

    def test_find(self):
        sl = SortedList([1, 3, 5, 7, 9])
        assert sl.find(min_key=3, max_key=7) == [3, 5, 7]
        assert sl.find(max_key=4) == [1, 3]

    def test_remove(self):
        sl = SortedList([4, 2, 6])
        sl.remove(4)
        assert list(sl) == [2, 6]


class TestLogging:
    def test_brace_format(self, caplog):
        import logging
        from canvas_tpu import logging as clog
        log = clog.getLogger('canvas_tpu.test')
        with caplog.at_level(logging.INFO, logger='canvas_tpu.test'):
            log.info('value is {0} and {name}', 42, name='x')
        assert 'value is 42 and x' in caplog.text

    def test_warnonerror(self, caplog):
        import logging
        from canvas_tpu import logging as clog
        log = clog.getLogger('canvas_tpu.test2')

        @log.warnonerror('callback failed')
        def bad():
            raise RuntimeError('boom')

        with caplog.at_level(logging.WARNING, logger='canvas_tpu.test2'):
            bad()  # must not raise
        assert 'callback failed' in caplog.text


def test_profiling_timers():
    from canvas_tpu import profiling

    profiling.reset()
    with profiling.Timer('stage_a'):
        pass
    with profiling.Timer('stage_a'):
        pass
    with profiling.Timer('stage_b'):
        pass
    rep = profiling.report()
    assert rep['stage_a'][1] == 2
    assert rep['stage_b'][1] == 1
    assert rep['stage_a'][0] >= 0.0
    profiling.reset()
    assert profiling.report() == {}


@pytest.mark.parametrize('env_set', [False, True])
def test_compile_cache_dir(monkeypatch, env_set):
    """JAX_COMPILATION_CACHE_DIR wins and nothing else is set; unset,
    the cache goes to .jax_cache at the root of the checkout (a fixed,
    git-ignored path)."""
    import jax

    from canvas_tpu import backend

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    updates = []
    monkeypatch.setattr(jax.config, 'update',
                        lambda k, v: updates.append((k, v)))
    if env_set:
        monkeypatch.setenv('JAX_COMPILATION_CACHE_DIR', '/elsewhere/cache')
        assert backend.compile_cache_dir() == '/elsewhere/cache'
        backend.configure_compile_cache()
        assert updates == []
    else:
        monkeypatch.delenv('JAX_COMPILATION_CACHE_DIR', raising=False)
        want = os.path.join(root, '.jax_cache')
        assert backend.compile_cache_dir() == want
        backend.configure_compile_cache()
        assert ('jax_compilation_cache_dir', want) in updates
        with open(os.path.join(root, '.gitignore')) as f:
            assert '.jax_cache/' in f.read().split()


def test_ensure_initialized_keeps_platform(monkeypatch):
    """ensure_initialized initializes the configured platform once and
    never switches it: there is no probe and no CPU fallback."""
    import jax

    from canvas_tpu import backend

    before = jax.config.jax_platforms
    updates = []
    real_update = jax.config.update

    def spy(k, v):
        updates.append(k)
        real_update(k, v)

    monkeypatch.setattr(jax.config, 'update', spy)
    monkeypatch.setattr(backend, '_initialized', False)
    backend.ensure_initialized()
    backend.ensure_initialized()
    assert 'jax_platforms' not in updates
    assert jax.config.jax_platforms == before
    assert backend._initialized
    assert not hasattr(backend, 'probe_device')


class TestEZListSemantics:
    """list semantics for integer bounds and extended slices (the old
    slice-fallback paths silently appended on out-of-range indices and
    corrupted the list on step != 1 mutations)."""

    def test_integer_bounds(self):
        import pytest
        lst = SimpleEZ([1, 2, 3])
        with pytest.raises(IndexError):
            lst[5] = 99
        with pytest.raises(IndexError):
            lst[-5] = 99
        with pytest.raises(IndexError):
            del lst[3]
        with pytest.raises(IndexError):
            del lst[-4]
        assert list(lst) == [1, 2, 3]
        lst[-1] = 30
        assert list(lst) == [1, 2, 30]
        del lst[-3]
        assert list(lst) == [2, 30]

    def test_extended_slice_delete(self):
        lst = SimpleEZ(['a', 'b', 'c', 'd'])
        del lst[::2]
        assert list(lst) == ['b', 'd']
        lst2 = SimpleEZ([0, 1, 2, 3, 4, 5])
        del lst2[::-2]                       # indices 5, 3, 1
        assert list(lst2) == [0, 2, 4]

    def test_extended_slice_assign(self):
        import pytest
        lst = SimpleEZ([0, 1, 2, 3])
        lst[::2] = [10, 20]
        assert list(lst) == [10, 1, 20, 3]
        with pytest.raises(ValueError):
            lst[::2] = [1, 2, 3]

    def test_marks_survive_extended_delete(self):
        lst = SimpleEZ([0, 1, 2, 3, 4, 5])
        mark = lst.create_mark(4, True)
        del lst[1:6:2]                       # removes 1, 3, 5
        assert list(lst) == [0, 2, 4]
        assert mark.index == 2               # slid left past two removals


def test_signal_builtin_bound_method():
    """Builtin bound methods (list.append) have __self__ but no
    __func__; __slots__ objects refuse weakrefs — both must connect
    (held strongly) instead of raising."""
    from canvas_tpu.signal import Signal
    sig = Signal()
    got = []
    sig.connect(got.append)
    sig(7)
    assert got == [7]
    sig.disconnect(got.append)
    sig(8)
    assert got == [7]

    class Slotted:
        __slots__ = ('hits',)

        def __init__(self):
            self.hits = 0

        def bump(self, *a):
            self.hits += 1

    s = Slotted()
    sig.connect(s.bump)
    sig()
    assert s.hits == 1
