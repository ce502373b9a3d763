"""Checkpoint and resume for batched simulation states, in the JAX package's file format.

The engine is deterministic in (state, tick count), so a checkpoint is
the state's leaves in an npz file: save at any tick, load, continue —
bit-identical to an uninterrupted run.  The file is the JAX package's
(its `engine/checkpoint.py`, format 2, layout `timewheel-v3`), so a
checkpoint crosses between the packages in both directions:

- one npz entry per leaf, keyed by its path as the JAX package flattens
  the same state: `time`, `x`, ..., `proto/<name>` (sorted),
  `faults/<field>`, `tele/<field>` (field order); ETHPoW's state by
  field index (`0`, `1`, ...), the keys the JAX package's dataclass
  gives; a plain dict by its sorted keys.  Leaves are stored in the JAX
  package's dtypes (`interop.state_to_numpy`): word leaves as uint32;
- `__engine_layout__` stamps the layout and `__manifest__` holds the
  JSON manifest: the side-car signature (telemetry / fault state
  attached or not), per-leaf crc32, shape and dtype, caller metadata
  and the trace ids (`manifest_trace`);
- writes are atomic: a pid-suffixed temp file, then `os.replace`.

Loading checks the layout, the side-car signature, every leaf's
shape, dtype and crc32, and puts the tensors on the template's device.
A flipped bit is `CheckpointCorruptError` naming the leaf; a side-car
mismatch is `CheckpointLayoutError`, before any leaf is read.

Layout compatibility is the JAX package's: an unknown stamp never loads;
`timewheel-v1` loads only into a template without side-cars;
`timewheel-v2` stored int32 where v3 packs int16/int8, and such leaves
cast down under a range check with the int32 maximum (the "never"
sentinel) remapped to the narrow dtype's maximum.

`CheckpointManager` keeps numbered checkpoints in one directory with an
atomic `LATEST` pointer and bounded retention, and restores the newest
one that loads, walking back past corrupt files.
"""

from __future__ import annotations

import json
import os
import time
import zipfile
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..interop import state_from_numpy, state_to_numpy
from .core import SimState

LAYOUT_KEY = "__engine_layout__"
MANIFEST_KEY = "__manifest__"
ENGINE_LAYOUT = "timewheel-v3"
# older stamps that still load, with the restrictions of load_state
COMPAT_LAYOUTS = ("timewheel-v1", "timewheel-v2")
MANIFEST_FORMAT = 2


class CheckpointError(Exception):
    """Base for every structured checkpoint failure."""


class CheckpointLayoutError(CheckpointError, ValueError):
    """Engine-layout or side-car signature mismatch: the checkpoint was
    written by an incompatible engine generation or configuration."""


class CheckpointCorruptError(CheckpointError, ValueError):
    """The checkpoint file is truncated, unreadable, or fails its
    integrity checksum."""


class CheckpointMissingLeafError(CheckpointError, KeyError):
    """The checkpoint lacks a leaf the template requires."""


class CheckpointShapeError(CheckpointError, ValueError):
    """A stored leaf's shape or dtype disagrees with the template."""


def _is_ethpow(tree) -> bool:
    from ..protocols.ethpow_batched import EthPowState

    return isinstance(tree, EthPowState)


def _host_leaves(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, numpy leaf) pairs in the JAX package's flattening order, for
    a SimState, an EthPowState, or a dict of arrays or tensors."""
    key = (lambda k: f"{prefix}/{k}") if prefix else str
    if _is_ethpow(tree):
        # the JAX package's EthPowState is a pytree class without key
        # names: its paths are the field indices
        return [(key(i), v) for i, v in enumerate(state_to_numpy(tree).values())]
    if isinstance(tree, SimState):
        host = state_to_numpy(tree)
        out = []
        for f in SimState._fields:
            v = host[f]
            if f == "proto":
                out += _host_leaves(v, key(f))
            elif isinstance(v, dict):  # a side-car, in its field order
                out += [(f"{key(f)}/{k}", a) for k, a in v.items()]
            elif not (isinstance(v, tuple) and not v):
                out.append((key(f), v))
        return out
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _host_leaves(tree[k], key(k))]
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree.detach().cpu().numpy())]
    return [(prefix, np.asarray(tree))]


def _template_device(state) -> torch.device:
    """The device of a SimState's or EthPowState's tensors."""
    return state.time.device


def _rebuild(template, arrays: Dict[str, np.ndarray], prefix: str = ""):
    """`template`'s structure with its leaves taken from `arrays` (keyed
    by path), tensors on the template's device."""
    key = (lambda k: f"{prefix}/{k}") if prefix else str
    if _is_ethpow(template):
        host = {f: arrays[key(i)] for i, f in enumerate(template._fields)}
        return state_from_numpy(host, _template_device(template))
    if isinstance(template, SimState):
        host = {}
        for f in SimState._fields:
            v = getattr(template, f)
            if f == "proto":
                host[f] = {k: arrays[f"{key(f)}/{k}"] for k in v}
            elif hasattr(v, "_fields"):
                host[f] = {k: arrays[f"{key(f)}/{k}"] for k in v._fields}
            elif isinstance(v, torch.Tensor):
                host[f] = arrays[key(f)]
            else:
                host[f] = v
        return state_from_numpy(host, _template_device(template))
    if isinstance(template, dict):
        return {k: _rebuild(template[k], arrays, key(k)) for k in template}
    arr = arrays[prefix]
    if isinstance(template, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(template.device)
    return np.array(arr)


def _sidecar_name(leaf: Any) -> Optional[str]:
    """The attached side-car's type name, or None when it is off (())."""
    if isinstance(leaf, tuple) and len(leaf) == 0:
        return None
    return type(leaf).__name__


def _sidecar_signature(state: Any) -> Dict[str, Optional[str]]:
    sig: Dict[str, Optional[str]] = {}
    for name in ("tele", "faults"):
        if hasattr(state, name):
            sig[name] = _sidecar_name(getattr(state, name))
    return sig


def manifest_trace(manifest: Optional[dict]) -> dict:
    """The correlation ids of a manifest: its `trace` block when present,
    else the run_id/job_id/tenant_id keys of its meta; {} when untraced."""
    if not manifest:
        return {}
    block = manifest.get("trace")
    if block:
        return dict(block)
    meta = manifest.get("meta") or {}
    return {k: meta[k] for k in ("run_id", "job_id", "tenant_id") if meta.get(k) is not None}


def save_state(state: Any, dest: str, meta: Optional[dict] = None) -> dict:
    """Write a state (a SimState, an EthPowState, or a dict of arrays or
    tensors) to `dest` (.npz), keyed by leaf path, with its manifest,
    atomically: a crashed writer leaves at most a stray temp file.
    Returns the manifest."""
    arrays = {LAYOUT_KEY: np.asarray(ENGINE_LAYOUT)}
    leaf_info: Dict[str, dict] = {}
    for key, leaf in _host_leaves(state):
        arr = np.asarray(leaf)
        arrays[key] = arr
        leaf_info[key] = {
            "crc32": zlib.crc32(arr.tobytes()) & 0xFFFFFFFF,
            "shape": list(arr.shape),
            "dtype": str(arr.dtype),
        }
    manifest = {
        "format": MANIFEST_FORMAT,
        "layout": ENGINE_LAYOUT,
        "sidecars": _sidecar_signature(state),
        "leaves": leaf_info,
        "meta": dict(meta or {}),
        "created_unix": time.time(),
    }
    trace = manifest_trace(manifest)
    if trace:
        manifest["trace"] = trace
    arrays[MANIFEST_KEY] = np.asarray(json.dumps(manifest))
    # savez appends .npz to a name without it; the pid keeps concurrent
    # writers off each other's temp file
    tmp = f"{dest}.tmp.{os.getpid()}.npz"
    try:
        np.savez_compressed(tmp, **arrays)
        os.replace(tmp, dest)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return manifest


def _open_npz(src: str):
    try:
        return np.load(src, allow_pickle=False)
    except FileNotFoundError:
        raise
    except (zipfile.BadZipFile, ValueError, OSError, EOFError) as e:
        raise CheckpointCorruptError(
            f"checkpoint {src} is unreadable (truncated or not an npz): {e}"
        ) from e


def _manifest_of(src: str, data) -> Optional[dict]:
    if MANIFEST_KEY not in data:
        return None
    try:
        return json.loads(str(data[MANIFEST_KEY]))
    except (json.JSONDecodeError, zlib.error, zipfile.BadZipFile) as e:
        raise CheckpointCorruptError(f"checkpoint {src} has a corrupt manifest: {e}") from e


def read_manifest(src: str) -> Optional[dict]:
    """The embedded manifest, or None for a pre-manifest (v1) checkpoint.
    Raises CheckpointCorruptError on an unreadable file."""
    with _open_npz(src) as data:
        return _manifest_of(src, data)


def _check_layout(src: str, found: str, template: Any) -> None:
    if found == ENGINE_LAYOUT:
        return
    if found in COMPAT_LAYOUTS:
        # v1 predates the side-car signature: the counters it never
        # stored are part of the bit-identity contract when armed
        armed = [k for k, v in _sidecar_signature(template).items() if v is not None]
        if armed:
            raise CheckpointLayoutError(
                f"checkpoint {src} was written by pre-side-car engine "
                f"layout {found!r}, but the template has "
                f"{'/'.join(armed)} side-car state attached; it cannot "
                "resume an instrumented run — re-run instead of resuming"
            )
        return
    raise CheckpointLayoutError(
        f"checkpoint {src} was written by engine layout {found!r}; this "
        f"engine is {ENGINE_LAYOUT!r} (compat: {COMPAT_LAYOUTS}) — "
        "re-run the simulation instead of resuming"
    )


def _coerce_dtype(src: str, key: str, arr, want_dtype):
    """Cast a compat-era int32 leaf down to the template's narrow dtype:
    the source maximum (the "never"/empty sentinel) becomes the narrow
    maximum, and every other value must fit the narrow range."""
    a, w = arr.dtype, np.dtype(want_dtype)
    if not (
        np.issubdtype(a, np.integer)
        and np.issubdtype(w, np.integer)
        and np.iinfo(a).max > np.iinfo(w).max
    ):
        raise CheckpointShapeError(
            f"leaf {key!r}: checkpoint {src} stores dtype {a}, template "
            f"wants {w} — not a compat-era widening to cast down"
        )
    dst = np.iinfo(w)
    is_sent = arr == np.iinfo(a).max
    rest = arr[~is_sent]
    if rest.size and (int(rest.min()) < dst.min or int(rest.max()) > dst.max):
        raise CheckpointShapeError(
            f"leaf {key!r}: checkpoint {src} holds values in "
            f"[{int(rest.min())}, {int(rest.max())}] that do not fit the "
            f"template's {w} — the narrow layout cannot represent this "
            "state; re-run instead of resuming"
        )
    out = arr.astype(w)
    out[is_sent] = dst.max
    return out


def load_state(template: Any, src: str, verify: bool = True) -> Any:
    """Rebuild a state with `template`'s structure from `src`, its tensors
    on the template's device.

    Shapes and dtypes must match the template's leaves, except that a
    compat-era checkpoint's wider integers cast down (`_coerce_dtype`).
    With `verify` every leaf is checked against its manifest crc32,
    computed on the stored bytes before any cast."""
    with _open_npz(src) as data:
        found_layout = str(data[LAYOUT_KEY]) if LAYOUT_KEY in data else None
        if found_layout is not None:
            _check_layout(src, found_layout, template)
        compat = found_layout in COMPAT_LAYOUTS
        manifest = _manifest_of(src, data)
        if manifest is not None:
            have_sig = manifest.get("sidecars", {})
            for name, want in _sidecar_signature(template).items():
                have = have_sig.get(name)
                if have != want:
                    raise CheckpointLayoutError(
                        f"checkpoint {src} side-car mismatch on {name!r}: "
                        f"saved with {have!r}, template expects {want!r} — "
                        "arm the run the same way it was saved"
                    )
        arrays: Dict[str, np.ndarray] = {}
        for key, want in _host_leaves(template):
            if key not in data:
                # every leaf is part of the bit-identity contract
                raise CheckpointMissingLeafError(f"checkpoint {src} is missing leaf {key!r}")
            try:
                arr = data[key]
            except (zipfile.BadZipFile, zlib.error, ValueError, EOFError) as e:
                raise CheckpointCorruptError(
                    f"checkpoint {src} leaf {key!r} is unreadable (truncated archive?): {e}"
                ) from e
            want = np.asarray(want)
            if arr.shape != want.shape or (arr.dtype != want.dtype and not compat):
                raise CheckpointShapeError(
                    f"leaf {key!r}: checkpoint has {arr.shape}/{arr.dtype}, "
                    f"template wants {want.shape}/{want.dtype}"
                )
            if verify and manifest is not None:
                info = manifest.get("leaves", {}).get(key)
                if info is not None:
                    crc = zlib.crc32(arr.tobytes())
                    if (crc & 0xFFFFFFFF) != info.get("crc32"):
                        raise CheckpointCorruptError(
                            f"checkpoint {src} leaf {key!r} failed its "
                            f"integrity checksum (stored crc32 "
                            f"{info.get('crc32')}, recomputed {crc}) — "
                            "the file is corrupt; falling back to an "
                            "older checkpoint is safe, this one is not"
                        )
            if arr.dtype != want.dtype:
                arr = _coerce_dtype(src, key, arr, want.dtype)
            arrays[key] = arr
        return _rebuild(template, arrays)


LATEST_NAME = "LATEST"
_CKPT_FMT = "ckpt_{step:08d}.npz"


class CheckpointManager:
    """Numbered checkpoints in one directory with bounded retention.

    - `save(state, step, meta)` writes `ckpt_{step:08d}.npz` atomically,
      then atomically updates the `LATEST` pointer file, then prunes to
      the `keep` newest files: a crash between any two steps leaves a
      consistent directory.
    - `restore_latest(template)` walks newest to oldest, skipping
      checkpoints that fail to load (corrupt, truncated, another side-car
      signature), and returns `(state, step, manifest)` for the newest
      loadable one, or None.
    """

    def __init__(self, directory: str, keep: int = 3):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def path_for(self, step: int) -> str:
        return os.path.join(self.directory, _CKPT_FMT.format(step=step))

    def steps(self) -> list:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("ckpt_") and name.endswith(".npz"):
                try:
                    out.append(int(name[len("ckpt_"):-len(".npz")]))
                except ValueError:
                    continue
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        """The step the LATEST pointer names, else the newest file."""
        ptr = os.path.join(self.directory, LATEST_NAME)
        try:
            with open(ptr) as f:
                name = f.read().strip()
            step = int(name[len("ckpt_"):-len(".npz")])
            if os.path.exists(self.path_for(step)):
                return step
        except (OSError, ValueError):
            pass
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, state: Any, step: int, meta: Optional[dict] = None) -> dict:
        manifest = save_state(state, self.path_for(step), meta=meta)
        ptr = os.path.join(self.directory, LATEST_NAME)
        tmp = f"{ptr}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(_CKPT_FMT.format(step=step))
        os.replace(tmp, ptr)
        self._prune()
        return manifest

    def _prune(self) -> None:
        steps = self.steps()
        for step in steps[: max(0, len(steps) - self.keep)]:
            try:
                os.remove(self.path_for(step))
            except OSError:
                pass

    def restore_latest(self, template: Any) -> Optional[Tuple[Any, int, Optional[dict]]]:
        for step in reversed(self.steps()):
            path = self.path_for(step)
            try:
                state = load_state(template, path)
                return state, step, read_manifest(path)
            except FileNotFoundError:
                continue
            except CheckpointError:
                continue
        return None
