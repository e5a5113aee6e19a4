"""Assets, plugin-backed sources, and projects.

Behavioral rebuild of /root/reference/fluggo/editor/model/sources.py:
Asset (:31-86), _SpaceSource/SpaceAsset (:88-182), PluginSource/
PluginSourceAsset (:233-388), RuntimeSource/RuntimeSourceAsset
(:389-419), AssetStreamRef (:421-456), AssetList (:458-506), Project
(:508-533), with YAML tags. The class/method inventory and failure
texts are the reference's public contract (tests assert them); the
internal structure — staged resolution, the shared load-alert
lifecycle, declarative definition fields, and the single YAML
registry — is ours.
"""

from collections.abc import MutableMapping

import yaml

from canvas_tpu.basetypes import register_yaml
from canvas_tpu import logging as _logging
from canvas_tpu.editor import plugins
from canvas_tpu.signal import Signal

register_yaml()

_log = _logging.getLogger(__name__)

__all__ = ['Asset', 'SpaceAsset', 'PluginSource', 'PluginSourceAsset',
           'RuntimeSource', 'RuntimeSourceAsset', 'AssetStreamRef',
           'AssetList', 'Project']


class _LoadAlertMixin:
    """Shared lifecycle for a source's single retained load-failure
    alert: publish on failure, retract before every retry. Used by both
    _SpaceSource and PluginSource."""

    _load_alert = None

    def _clear_load_alert(self):
        if self._load_alert:
            self.hide_alert(self._load_alert)
            self._load_alert = None

    def _publish_load_alert(self, description, *, model_obj,
                            actions=(), exc_info=False):
        alert = plugins.Alert(description, icon=plugins.AlertIcon.Error,
                              source=self.name, model_obj=model_obj,
                              actions=list(actions), exc_info=exc_info)
        self._load_alert = alert
        self.show_alert(alert)


def _unexpected(verb, ex):
    """The reference's failure-text shape for exception alerts:
    'Unexpected <Type> while <verb>: <message>'."""
    return ('Unexpected ' + type(ex).__name__ + ' while '
            + verb + ': ' + str(ex))


class Asset:
    yaml_tag = '!Asset'

    #: True if the asset can be used as a source.
    is_source = False
    #: True if the editor can open a composition editor for this asset.
    is_composition = False
    #: True if this asset can contain other assets.
    contains_assets = False

    def __init__(self, name, keywords=()):
        self.name = name
        self._keywords = frozenset(keywords)
        self.keywords_updated = Signal()
        self._asset_list = None

    # Subclasses list (definition-key, callable) pairs here; the
    # base get_definition folds them in so each subclass declares
    # WHAT it persists, not another serialization method body.
    definition_fields = ()

    def get_definition(self):
        d = {'keywords': list(self._keywords)}
        for key, get in type(self).definition_fields:
            d[key] = get(self)
        return d

    def get_source(self):
        return None

    def create_composition_editor(self):
        raise NotImplementedError

    asset_list = property(lambda self: self._asset_list)
    keywords = property(lambda self: self._keywords)
    # Full hierarchical paths are a reference TODO as well; the name is
    # the path until assets nest.
    path = property(lambda self: self.name)

    def fixup(self):
        pass


class _SpaceSource(_LoadAlertMixin, plugins.Source):
    """Source view of a Space: compiles it through the graph managers
    (sources.py:88-147)."""

    #: (attribute, stream label, graph manager factory name) — the two
    #: compiled stream views every space exposes.
    _MANAGERS = (('_video', 'Video', 'SpaceVideoManager'),
                 ('_audio', 'Audio', 'SpaceAudioManager'))

    def __init__(self, space, asset_list):
        plugins.Source.__init__(self, space.name)
        self._space = space
        self._asset_list = asset_list
        for attr, _label, _factory in self._MANAGERS:
            setattr(self, attr, None)

    def bring_online(self):
        self._clear_load_alert()
        try:
            from canvas_tpu.editor import graph
            for attr, label, factory in self._MANAGERS:
                manager = getattr(graph, factory)(self._space,
                                                  self._asset_list)
                manager.name = label
                # Assign BEFORE following: if follow_alerts raises, the
                # except-path take_offline only unfollows managers it
                # finds in the attributes.
                setattr(self, attr, manager)
                self.follow_alerts(manager)
            plugins.Source.bring_online(self)
        except Exception as ex:
            _log.debug('Error while creating source for space "{0}"',
                       self.name, exc_info=True)
            self.take_offline()
            self._publish_load_alert(
                _unexpected('creating source from space', ex),
                model_obj=self._space, exc_info=True)

    def take_offline(self):
        self._clear_load_alert()
        for attr, _label, _factory in self._MANAGERS:
            manager = getattr(self, attr)
            if manager:
                self.unfollow_alerts(manager)
                # Detach from the model: a dropped manager must stop
                # processing Space edits (and its nested sequence
                # managers theirs), or every offline/online cycle
                # leaks a live graph.
                manager.unwatch()
                setattr(self, attr, None)
        plugins.Source.take_offline(self)

    def get_streams(self):
        if self.offline:
            raise plugins.SourceOfflineError
        return [getattr(self, attr) for attr, _l, _f in self._MANAGERS]


class SpaceAsset(Asset):
    yaml_tag = '!SpaceAsset'
    is_source = True
    is_composition = True

    def __init__(self, space, **kw):
        Asset.__init__(self, **kw)
        self._space = space
        self._source = None

    space = property(lambda self: self._space)
    definition_fields = (('space', lambda self: self._space),)

    def get_source(self):
        if not self._asset_list:
            raise RuntimeError('Asset list not set on asset')
        if not self._source:
            self._source = _SpaceSource(self._space, self._asset_list)
        return self._source

    def fixup(self):
        Asset.fixup(self)
        self._space.fixup()


class PluginSource(_LoadAlertMixin, plugins.Source):
    """A source loaded through a plugin by URN + definition, with
    alert-based retry on failure (sources.py:233-368)."""

    def __init__(self, name, plugin_urn, definition, **kw):
        plugins.Source.__init__(self, name, **kw)
        self.definition = definition
        self.plugin_urn = plugin_urn
        self._plugin = None
        self._source = None

    def _handle_offline_changed(self, source):
        self.offline = self._source.offline

    def _fail(self, description, exc_info=False):
        self._publish_load_alert(
            description, model_obj=self,
            actions=[('Retry', self._retry_load)], exc_info=exc_info)

    # bring_online is a staged resolution pipeline: each stage either
    # completes (returns True) or publishes its failure alert and
    # returns False. Alerts are raised INSIDE the failing stage's
    # except block so Alert's sys.exc_info() capture sees the live
    # traceback. The set of stages and their failure texts match the
    # reference semantics (sources.py:233-368) that
    # tests/test_editor_model.py asserts; the decomposition is ours.

    def _stage_find_plugin(self):
        if self._plugin:
            return True
        self._plugin = plugins.PluginManager.find_plugin_by_urn(
            self.plugin_urn)
        if self._plugin is not None:
            return True
        _log.debug("Couldn't find plugin {0} for source {1}",
                   self.plugin_urn, self.name)
        self._fail('Plugin ' + self.plugin_urn
                   + ' unavailable or disabled')
        return False

    def _stage_create_source(self):
        if self._source:
            return True
        created = None
        try:
            created = self._plugin.create_source(self.name,
                                                 self.definition)
            created.offline_changed.connect(self._handle_offline_changed)
            self.follow_alerts(created)
            self._source = created
        except Exception as ex:
            self._source = None
            if created is not None:
                # undo a half-wired connection so a later
                # offline_changed can't fire into a None _source
                try:
                    created.offline_changed.disconnect(
                        self._handle_offline_changed)
                except Exception:
                    pass
            _log.debug('Error while creating source {0} from plugin',
                       self.name, exc_info=True)
            self._fail(_unexpected('creating source from plugin', ex),
                       exc_info=True)
            return False
        return True

    def _stage_activate(self):
        if not self._source.offline:
            return True
        try:
            self._source.bring_online()
        except Exception as ex:
            _log.debug('Error while bringing source {0} online',
                       self.name, exc_info=True)
            self._fail(_unexpected('bringing source online', ex),
                       exc_info=True)
            return False
        return True

    def bring_online(self):
        if not self.offline:
            return
        self._clear_load_alert()
        for stage in (self._stage_find_plugin, self._stage_create_source,
                      self._stage_activate):
            if not stage():
                return
        if not self._source.offline:
            self.offline = False

    def _retry_load(self, checked=False):
        self.bring_online()

    def take_offline(self):
        if self.offline or not self._source:
            return
        try:
            self._source.take_offline()
        except Exception:
            pass
        self.offline = True

    file_path = property(
        lambda self: self._source.file_path if self._source else None)

    def get_definition(self):
        return {'plugin_urn': self.plugin_urn,
                'definition': (self._source.get_definition()
                               if self._source else self.definition)}

    @classmethod
    def from_plugin_source(cls, source):
        return cls(source.name, source.plugin.plugin_urn,
                   source.get_definition())

    def _online_source(self):
        """The wrapped live source, or SourceOfflineError when this
        source is offline/unresolved (the guard every stream accessor
        shares)."""
        if self.offline or not self._source:
            raise plugins.SourceOfflineError
        return self._source

    def get_streams(self):
        return self._online_source().get_streams()

    def get_default_streams(self):
        return self._online_source().get_default_streams()

    def get_stream(self, name):
        return self._online_source().get_stream(name)


class PluginSourceAsset(Asset):
    yaml_tag = '!PluginSourceAsset'
    is_source = True
    is_composition = False

    def __init__(self, name, plugin_urn, definition, **kw):
        Asset.__init__(self, name=name, **kw)
        self._source = PluginSource(name, plugin_urn, definition)

    definition_fields = (
        ('plugin_urn', lambda self: self._source.plugin_urn),
        ('definition',
         lambda self: self._source.get_definition()['definition']),
    )

    def get_source(self):
        return self._source


class RuntimeSource(plugins.Source):
    """A source with ready-made streams; not serializable (test support,
    sources.py:389-409)."""

    def __init__(self, name, streams):
        plugins.Source.__init__(self, name)
        self._streams = streams

    def _live_streams(self):
        if self.offline:
            raise plugins.SourceOfflineError
        return self._streams

    def get_stream_formats(self):
        return [(stream.name, stream.format)
                for stream in self._streams.values()]

    def get_streams(self):
        return list(self._live_streams().values())

    def get_stream(self, name):
        return self._live_streams()[name]

    def get_definition(self):
        raise RuntimeError("Runtime sources can't be written to a file.")


class RuntimeSourceAsset(Asset):
    is_source = True

    def __init__(self, source):
        Asset.__init__(self, source.name)
        self._source = source

    def get_source(self):
        return self._source


class AssetStreamRef:
    """Reference to (asset path, stream name) (sources.py:421-456).
    Value semantics: equality and hash follow the pair."""

    yaml_tag = '!AssetStreamRef'

    def __init__(self, asset_path=None, stream=None, **kw):
        self._asset_path = asset_path
        self._stream = stream

    asset_path = property(lambda self: self._asset_path)
    stream = property(lambda self: self._stream)

    def _key(self):
        return (self._asset_path, self._stream)

    def get_definition(self):
        return {'asset_path': self._asset_path, 'stream': self._stream}

    def __eq__(self, other):
        return (isinstance(other, AssetStreamRef)
                and other._key() == self._key())

    def __hash__(self):
        return hash(self._key())


class AssetList(MutableMapping):
    def __init__(self, assets=None):
        self.assets = assets or {}
        self.added = Signal()
        self.renamed = Signal()
        self.removed = Signal()

    def _adopt(self, name, asset):
        self.assets[name] = asset
        asset._asset_list = self
        asset.name = name

    def _orphan(self, name):
        """Announce removal, then detach — the removed() handlers are
        the last to see the asset still named and listed."""
        asset = self.assets[name]
        self.removed(name)
        asset._asset_list = None
        asset.name = None
        return asset

    def __getitem__(self, name):
        return self.assets[name]

    def __setitem__(self, name, value):
        if self.assets.get(name):
            self._orphan(name)
        self._adopt(name, value)
        self.added(name)

    def __delitem__(self, name):
        self._orphan(name)
        del self.assets[name]

    def __len__(self):
        return len(self.assets)

    def __iter__(self):
        return iter(self.assets)

    def get_asset_list(self):
        return self.assets

    def fixup(self):
        # Re-bind names/backlinks first so every asset's fixup sees a
        # consistent list, then let each asset repair itself.
        for name, asset in self.assets.items():
            asset.name = name
            asset._asset_list = self
        for asset in self.assets.values():
            asset.fixup()


class Project:
    yaml_tag = '!Project'

    def __init__(self, known_formats=None, assets=None,
                 project_settings=None):
        self._known_formats = {} if known_formats is None else known_formats
        self._assets = {} if assets is None else assets
        self._project_settings = ({} if project_settings is None
                                  else project_settings)

    def fixup(self):
        if isinstance(self._assets, dict):
            self._assets = AssetList(assets=self._assets)
        self._assets.fixup()

    assets = property(lambda self: self._assets)

    def get_definition(self):
        assets = (self._assets.get_asset_list()
                  if isinstance(self._assets, AssetList) else self._assets)
        return {'known_formats': self._known_formats,
                'assets': assets,
                'project_settings': self._project_settings}


# --- YAML registry -----------------------------------------------------------
# One representer shape for everything: dump = tagged get_definition()
# mapping; load = constructor over the mapping. Classes whose __init__
# takes a required positional (name, space) register a construct
# adapter instead of a second classmethod per type.

def _construct_kwargs(cls, **fixed):
    def construct(loader, node):
        mapping = loader.construct_mapping(node, deep=True)
        mapping.update(fixed)
        return cls(**mapping)
    return construct


def _space_asset_construct(loader, node):
    mapping = loader.construct_mapping(node, deep=True)
    return SpaceAsset(mapping.pop('space'), name='', **mapping)


def _plugin_source_asset_construct(loader, node):
    mapping = loader.construct_mapping(node, deep=True)
    return PluginSourceAsset(
        name='', plugin_urn=mapping['plugin_urn'],
        definition=mapping['definition'],
        keywords=mapping.get('keywords', ()))


def _yamlreg(cls, construct):
    def represent(dumper, data):
        return dumper.represent_mapping(cls.yaml_tag,
                                        data.get_definition())
    # to_yaml/from_yaml remain as the public per-class hooks the rest
    # of the model layer expects on yaml-tagged types.
    cls.to_yaml = classmethod(lambda _cls, dumper, data:
                              represent(dumper, data))
    cls.from_yaml = classmethod(lambda _cls, loader, node:
                                construct(loader, node))
    yaml.add_representer(cls, represent)
    yaml.add_constructor(cls.yaml_tag, construct)


_yamlreg(Asset, _construct_kwargs(Asset, name=''))
_yamlreg(AssetStreamRef, _construct_kwargs(AssetStreamRef))
_yamlreg(Project, _construct_kwargs(Project))
_yamlreg(SpaceAsset, _space_asset_construct)
_yamlreg(PluginSourceAsset, _plugin_source_asset_construct)
