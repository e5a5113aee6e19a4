"""The timeline container.

Behavioral rebuild of /root/reference/fluggo/editor/model/space.py:
Space is an EZList of items ordered by z (index == z), with anchor maps,
overlap queries, and the !CanvasSpace YAML tag.
"""

import yaml

from canvas_tpu.basetypes import register_yaml
from canvas_tpu import ezlist
from canvas_tpu.signal import Signal
from canvas_tpu import logging as _logging

register_yaml()

_log = _logging.getLogger(__name__)

__all__ = ['Space']


class Space(ezlist.EZList):
    def __init__(self, name, video_format, audio_format):
        ezlist.EZList.__init__(self)
        self.name = name
        self.item_added = Signal()
        self.item_removed = Signal()
        self._items = []
        self._video_format = video_format
        self._audio_format = audio_format
        self._anchor_map = {}

    def rate(self, item_type):
        """Units-per-second rate of the X axis for *item_type*
        (space.py:39-46)."""
        if item_type == 'video':
            return self._video_format.frame_rate
        if item_type == 'audio':
            return self._audio_format.sample_rate
        raise KeyError(item_type)

    def __len__(self):
        return len(self._items)

    def __getitem__(self, key):
        return self._items[key]

    video_format = property(lambda self: self._video_format)
    audio_format = property(lambda self: self._audio_format)

    def index(self, item, i=None, j=None):
        if self != item._space:
            raise ValueError
        if i is None and j is None:
            return item._z
        i = 0 if i is None else i
        i = max(0, i + len(self) if i < 0 else i)
        j = len(self) if j is None else j
        j = max(0, j + len(self) if j < 0 else j)
        result = item._z
        if i <= result < j:
            return result
        return None

    def _replace_range(self, start, stop, items):
        old_set = frozenset(self._items[start:stop])
        new_set = frozenset(items)

        for item in (old_set - new_set):
            self.item_removed(item)
            item.kill()

        self._items[start:stop] = items
        self._update_marks(start, stop, len(items))

        for item in self._items[start:]:
            item._space = self

        # Renumber z; direction avoids transient duplicate z values
        # (space.py:96-107)
        if len(old_set) > len(new_set):
            for i, item in enumerate(self._items[start:], start):
                item.update(z=i)
        elif len(new_set) > len(old_set):
            for i, item in reversed(list(enumerate(self._items[start:],
                                                   start))):
                item.update(z=i)
        else:
            for i, item in enumerate(self._items[start:stop], start):
                item.update(z=i)

        for item in (new_set - old_set):
            item.fixup()
            self.item_added(item)

    def fixup(self):
        """First-time initialization after deserialization
        (space.py:113-122)."""
        for i, item in enumerate(self._items):
            item._space = self
            item._z = i
            item.fixup()

    def add_anchor_map(self, source, target):
        myset = self._anchor_map.setdefault(target, set())
        if source in myset:
            _log.debug('WARNING: Adding anchor map that already exists!!!')
        else:
            myset.add(source)

    def remove_anchor_map(self, source, target):
        myset = self._anchor_map.get(target)
        if not myset or source not in myset:
            _log.debug("WARNING: Removing anchor map that doesn't exist!!!")
            return
        myset.remove(source)
        if not myset:
            del self._anchor_map[target]

    def find_overlaps(self, item):
        return [other for other in self._items
                if item is not other and item.overlaps(other)]

    def find_overlaps_recursive(self, start_item):
        """Transitive overlaps, walking straight up and straight down the
        z stack (space.py:151-178)."""
        first = self.find_overlaps(start_item)
        up = set(x for x in first if x.z > start_item.z)
        down = set(x for x in first if x.z < start_item.z)
        result = up | down

        while up:
            current = set()
            for item in up:
                current |= frozenset(
                    x for x in self.find_overlaps(item)
                    if x.z > item.z) - result
                result |= current
            up = current

        while down:
            current = set()
            for item in down:
                current |= frozenset(
                    x for x in self.find_overlaps(item)
                    if x.z < item.z) - result
                result |= current
            down = current

        return result

    def find_immediate_anchored_items(self, target):
        return self._anchor_map.get(target, frozenset())

    def find_anchored_items(self, target):
        """Transitive closure of items anchored to *target*
        (space.py:184-202)."""
        results = set(self.find_immediate_anchored_items(target))
        if not results:
            return results
        last_count = 0
        while len(results) != last_count:
            last_count = len(results)
            new_results = set()
            for item in results:
                new_results.update(self.find_immediate_anchored_items(item))
            results.update(new_results)
        return results


def _space_represent(dumper, data):
    # The reference's representer writes only items while its
    # constructor expects the formats (space.py:211-218 — a reload
    # there loses them); serialize both so round trips keep the
    # space's frame/sample rates.
    return dumper.represent_mapping('!CanvasSpace', {
        'name': data.name,
        'items': data._items,
        'video_format': data._video_format,
        'audio_format': data._audio_format})


def _space_construct(loader, node):
    mapping = loader.construct_mapping(node, deep=True)
    result = Space(mapping.get('name', ''), mapping.get('video_format'),
                   mapping.get('audio_format'))
    result._items = mapping['items']
    return result


yaml.add_representer(Space, _space_represent)
yaml.add_constructor('!CanvasSpace', _space_construct)
