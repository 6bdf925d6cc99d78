# Frozen copy of voxelraytracing_tpu_torch/resources/packs.py at commit 5046bbb1c27cf55a0e0985dd2724f80b90766057
# (the benchmark's yardstick: later changes to the program do not reach it).
# Imports adjusted (constants inlined).

"""Data packs: voxel definitions, world presets, features, styles.

Loads and validates the engine's RON resource tree — functional equivalent of
the reference's resource system (common/src/resources/mod.rs:14-332,
loader.rs:43-348): a *datapack* defines voxel types, worldgen presets
(noise sources, biomes, biome lookup table) and named features; a *stylepack*
maps voxel names to render styles. Construction resolves voxel names to ids,
expands biome layer stacks (``depth`` -> repeated voxels), verifies feature
references, and rejects duplicate voxel names.

Layout (same tree shape as the reference's ``$CONFIG/blockworld``):

    <root>/datapacks/<pack>/{meta.ron, voxels.ron, world_features.ron, world_gen.ron}
    <root>/stylepacks/<pack>/{meta.ron, voxel_styles.ron}
    <root>/worlds/<world>/meta.ron

Port of ``voxelraytracing_tpu/resources/packs.py``: the same parse, with
the material table built by the port's ``ops/materials.py``.
"""

import os
from dataclasses import dataclass, field

from . import ron

CURRENT_VERSION = (0, 1)


class PackError(ValueError):
    pass


class VoxelNotFound(PackError):
    pass


class FeatureNotFound(PackError):
    pass


class DuplicateVoxel(PackError):
    pass


# ---------------------------------------------------------------- voxels

@dataclass(frozen=True)
class VoxelData:
    name: str
    state: str = "solid"  # "solid" | "liquid" | "gas"

    @property
    def is_solid(self):
        return self.state == "solid"

    @property
    def is_air(self):
        return self.state == "gas"


class VoxelPack:
    """All voxel types that can exist in a world; index = voxel id."""

    def __init__(self, voxels):
        VOXEL_MAX_VALUE = 0xFFFF // 2  # core/constants.py

        if len(voxels) >= VOXEL_MAX_VALUE:
            raise PackError(f"Too many voxel types ({len(voxels)})")
        self.voxels = list(voxels)
        self._by_name = {}
        for idx, v in enumerate(self.voxels):
            if v.name in self._by_name:
                raise DuplicateVoxel(v.name)
            self._by_name[v.name] = idx

    def by_name(self, name):
        idx = self._by_name.get(name)
        if idx is None:
            raise VoxelNotFound(name)
        return idx

    def get(self, voxel_id):
        return self.voxels[voxel_id] if 0 <= voxel_id < len(self.voxels) else None

    def __len__(self):
        return len(self.voxels)

    def __iter__(self):
        return iter(self.voxels)


def parse_voxelpack(src):
    raw = ron.loads(src)
    out = []
    for entry in raw:
        _expect_tag(entry, "VoxelData")
        state = entry.get("state")
        out.append(
            VoxelData(
                name=entry["name"],
                state=state.tag.lower() if state is not None else "solid",
            )
        )
    return VoxelPack(out)


# ---------------------------------------------------------------- noise maps

@dataclass(frozen=True)
class MapCfg:
    """freq/scale/offset noise transform (the RON ``Map`` struct)."""

    freq: float = 0.0
    scale: float = 0.0
    offset: float = 0.0


def _parse_map(node):
    _expect_tag(node, "Map")
    return MapCfg(
        freq=float(node.get("freq", 0.0)),
        scale=float(node.get("scale", 0.0)),
        offset=float(node.get("offset", 0.0)),
    )


@dataclass(frozen=True)
class SourceCfg:
    """A value field source: Value | Noise | ComplexNoise (resources/mod.rs:253-262)."""

    kind: str
    value: float = 0.0
    noise: MapCfg = None
    freq: MapCfg = None
    scale: MapCfg = None
    base: MapCfg = None
    layers: tuple = ()


def _parse_source(node):
    if node.tag == "Value":
        return SourceCfg(kind="value", value=float(node.args[0]))
    if node.tag == "Noise":
        return SourceCfg(kind="noise", noise=_parse_map(node.args[0]))
    if node.tag == "ComplexNoise":
        return SourceCfg(
            kind="complex",
            freq=_parse_map(node["freq"]),
            scale=_parse_map(node["scale"]),
            base=_parse_map(node["base"]),
            layers=tuple(_parse_map(m) for m in node.get("layers", [])),
        )
    raise PackError(f"Unknown source kind {node.tag!r}")


# ---------------------------------------------------------------- features

@dataclass(frozen=True)
class FeatureCfg:
    """One named worldgen feature (tree/cactus/spike/lake/...), voxel ids
    resolved (resources/mod.rs:186-238)."""

    kind: str
    params: dict


_FEATURE_VOXEL_FIELDS = ("trunk_voxel", "branch_voxel", "leaf_voxel", "voxel")
_FEATURE_KINDS = ("Tree", "CanopyTree", "Evergreen", "Cactus", "Spike", "Lake")


def parse_world_features(src, voxels: VoxelPack):
    raw = ron.loads(src)
    out = {}
    for name, node in raw.items():
        if node.tag not in _FEATURE_KINDS:
            raise PackError(f"Unknown feature kind {node.tag!r} for {name!r}")
        params = {}
        for key, val in node.items():
            if key in _FEATURE_VOXEL_FIELDS:
                params[key] = voxels.by_name(val)
            elif isinstance(val, tuple):
                params[key] = tuple(val)
            else:
                params[key] = val
        out[name] = FeatureCfg(kind=node.tag, params=params)
    return out


# ---------------------------------------------------------------- biomes & presets

@dataclass(frozen=True)
class BiomeCfg:
    name: str
    vegetation: MapCfg
    layers: tuple  # expanded: one voxel id per depth step (loader.rs:200-209)
    features: tuple  # feature names


@dataclass(frozen=True)
class WorldPresetCfg:
    name: str
    temp: SourceCfg
    humidity: SourceCfg
    weirdness: SourceCfg
    height: SourceCfg
    sea_level: int
    earth: int  # voxel id
    water: int  # voxel id
    biome_lookup: tuple  # 8 rows x 20 cols of biome indices
    biomes: tuple


def _parse_biome(node, voxels, features):
    _expect_tag(node, "RawBiome")
    layers = []
    for layer in node.get("layers", []):
        _expect_tag(layer, "RawLayer")
        vid = voxels.by_name(layer["voxel"])
        layers.extend([vid] * int(layer["depth"]))
    feats = tuple(node.get("features", []))
    for f in feats:
        if f not in features:
            raise FeatureNotFound(f)
    return BiomeCfg(
        name=node["name"],
        vegetation=_parse_map(node["vegetation"]),
        layers=tuple(layers),
        features=feats,
    )


def parse_world_presets(src, voxels: VoxelPack, features):
    raw = ron.loads(src)
    out = []
    for node in raw:
        _expect_tag(node, "RawWorldPreset")
        lookup = tuple(tuple(int(v) for v in row) for row in node["biome_lookup"])
        if len(lookup) != 8 or any(len(r) != 20 for r in lookup):
            raise PackError("biome_lookup must be 8 rows of 20 entries")
        biomes = tuple(_parse_biome(b, voxels, features) for b in node["biomes"])
        n = len(biomes)
        if any(v >= n for row in lookup for v in row):
            raise PackError("biome_lookup references missing biome")
        out.append(
            WorldPresetCfg(
                name=node["name"],
                temp=_parse_source(node["temp"]),
                humidity=_parse_source(node["humidity"]),
                weirdness=_parse_source(node["weirdness"]),
                height=_parse_source(node["height"]),
                sea_level=int(node["sea_level"]),
                earth=voxels.by_name(node["earth"]),
                water=voxels.by_name(node["water"]),
                biome_lookup=lookup,
                biomes=biomes,
            )
        )
    return out


# ---------------------------------------------------------------- styles

@dataclass(frozen=True)
class VoxelStyle:
    state: str = "gas"
    color: tuple = (0.0, 0.0, 0.0)
    emission: float = 0.0
    scatter: float = 1.0


def parse_voxel_stylepack(src):
    raw = ron.loads(src)
    out = {}
    for name, node in raw:
        if name in out:
            raise DuplicateVoxel(name)
        _expect_tag(node, "VoxelStyle")
        state = node.get("state")
        out[name] = VoxelStyle(
            state=state.tag.lower() if state is not None else "gas",
            color=tuple(float(c) for c in node.get("color", (0.0, 0.0, 0.0))),
            emission=float(node.get("emission", 0.0)),
            scatter=float(node.get("scatter", 1.0)),
        )
    return out


# ---------------------------------------------------------------- meta / packs

@dataclass(frozen=True)
class Meta:
    name: str
    version: tuple


@dataclass(frozen=True)
class WorldMeta:
    name: str
    version: tuple
    datapack: str
    stylepack: str
    seed: int = 0


def parse_meta(src):
    node = ron.loads(src)
    return Meta(name=node["name"], version=tuple(node["version"]))


def parse_world_meta(src):
    node = ron.loads(src)
    return WorldMeta(
        name=node["name"],
        version=tuple(node["version"]),
        datapack=node["datapack"],
        stylepack=node["stylepack"],
        seed=int(node.get("seed", 0)),
    )


@dataclass
class Datapack:
    path: str
    name: str
    version: tuple
    voxels: VoxelPack
    world_features: dict
    world_presets: list

    @classmethod
    def load_from(cls, path):
        meta = parse_meta(_read(path, "meta.ron"))
        voxels = parse_voxelpack(_read(path, "voxels.ron"))
        features = parse_world_features(_read(path, "world_features.ron"), voxels)
        presets = parse_world_presets(_read(path, "world_gen.ron"), voxels, features)
        return cls(
            path=path,
            name=meta.name,
            version=meta.version,
            voxels=voxels,
            world_features=features,
            world_presets=presets,
        )


@dataclass
class Stylepack:
    name: str
    version: tuple
    voxel_styles: dict

    @classmethod
    def load_from(cls, path):
        meta = parse_meta(_read(path, "meta.ron"))
        styles = parse_voxel_stylepack(_read(path, "voxel_styles.ron"))
        return cls(name=meta.name, version=meta.version, voxel_styles=styles)

    def material_table(self, voxels: VoxelPack, n_voxels=None):
        """Compile styles into the device material LUT, name-matched to the
        voxel pack (the ``Material::construct_arr`` equivalent,
        clientdesktop/src/graphics/mod.rs:49-60)."""
        from .materials import make_material_table

        styles = {}
        for vid, vd in enumerate(voxels):
            s = self.voxel_styles.get(vd.name)
            if s is not None:
                styles[vid] = {
                    "color": s.color,
                    "state": s.state,
                    "emission": s.emission,
                    "scatter": s.scatter,
                }
        return make_material_table(n_voxels or max(256, len(voxels)), styles)


@dataclass
class Resources:
    """The full resource tree: all datapacks, stylepacks and worlds."""

    path: str
    datapacks: dict = field(default_factory=dict)
    stylepacks: dict = field(default_factory=dict)
    worlds: list = field(default_factory=list)

    @classmethod
    def load_from(cls, root):
        out = cls(path=root)
        for sub, loader, sink in (
            ("datapacks", Datapack.load_from, out.datapacks),
            ("stylepacks", Stylepack.load_from, out.stylepacks),
        ):
            base = os.path.join(root, sub)
            if not os.path.isdir(base):
                continue
            for entry in sorted(os.listdir(base)):
                p = os.path.join(base, entry)
                if os.path.isdir(p):
                    pack = loader(p)
                    sink[pack.name] = pack
        out.reload_worlds()
        return out

    def reload_worlds(self):
        self.worlds = []
        base = os.path.join(self.path, "worlds")
        if not os.path.isdir(base):
            return
        for entry in sorted(os.listdir(base)):
            p = os.path.join(base, entry, "meta.ron")
            if os.path.isfile(p):
                with open(p, "r", encoding="utf-8") as f:
                    self.worlds.append(parse_world_meta(f.read()))


def _read(path, name):
    with open(os.path.join(path, name), "r", encoding="utf-8") as f:
        return f.read()


def _expect_tag(node, tag):
    if not isinstance(node, ron.Struct) or node.tag not in (tag, None):
        raise PackError(f"Expected {tag}, got {getattr(node, 'tag', type(node))}")


def builtin_respack_path():
    """Path of the respack bundled with this framework (the stdrespack analog)."""
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(here, "respack")
