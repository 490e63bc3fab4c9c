"""Checkpoints in the JAX package's on-disk layout v4.

Port of the JAX package's ``checkpoint/ckpt.py``. A checkpoint written by
either package restores in the other:

  step_000000123/
    manifest.json   {"step", "time", "layout": 4, "arrays": {path: {shape,
                    dtype, file, npz_key, crc32}}, "tile_groups": {group:
                    {members, policy}}, "tile_classes": {class: {groups,
                    members}}, plus the caller's ``extra`` keys}
    arrays_000.npz  leaf arrays keyed by ``npz_key(path)``, in chunks of
                    about 512 MB

Writes go to a tmp directory that is renamed into place (an existing step
is renamed to ``.old_*`` first); a ``latest`` symlink is updated last.

Dtypes on disk are JAX's. The port holds keys and seeds as int64 tensors of
uint32 words (``repro_torch.prng``): every int64 tensor is stored as uint32
and reads back as int64 (a value outside [0, 2**32) refuses to save). A
bfloat16 leaf is stored as JAX stores it, as 2-byte raw records (``<V2``)
with manifest dtype "bfloat16", and reads back as bfloat16, whichever
package wrote it.

``restore`` takes a template tree (tensors or ``TensorSpec`` leaves, a
``TileBank`` for the tiles) and puts every leaf where its template leaf
lives. It re-keys every older or differently partitioned tile layout into
the template's (the re-key matrix of ``docs/architecture.md``): v3
per-group stacks, coarser-keyed stacks, v1 per-tile checkpoints, and v4
classes sliced apart into other partitions.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
import warnings
import zipfile
import zlib
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ..core.paths import _children, flatten_with_path, npz_key, tree_map_with_path
from ..core.plan import policy_to_json
from ..core.tile import (TileBank, group_name, parse_class_name,
                         parse_group_name)
from ..distributed.sharding import rule_template, template_tag
from ..prng import MASK

_CHUNK_BYTES = 512 * 1024 * 1024
_RESERVED = {"step", "time", "layout", "arrays", "tile_groups", "tile_classes"}
_BF16_DESCR = "<V2"   # how numpy writes an ml_dtypes bfloat16 array


def _banks(tree):
    """Every TileBank in ``tree``, in JAX's leaf order."""
    if isinstance(tree, TileBank):
        yield tree
    elif isinstance(tree, (dict, list, tuple)):
        for _, child in _children(tree):
            yield from _banks(child)


def _tile_group_manifest(tree) -> Dict[str, Any]:
    """Per-group member paths (stacking order) and resolved policy of every
    TileBank in ``tree`` (manifest layout v3+)."""
    out: Dict[str, Any] = {}
    for bank in _banks(tree):
        for g, paths in bank.index:
            pol = bank.policy(g)
            out[g] = {"members": list(paths),
                      "policy": policy_to_json(pol) if pol is not None else None}
    return out


def _tile_class_manifest(tree) -> Dict[str, Any]:
    """Per-class member groups (class-stack order) with their member
    weight-paths (manifest layout v4)."""
    out: Dict[str, Any] = {}
    for bank in _banks(tree):
        pidx = dict(bank.index)
        for cname, gnames in bank.class_index:
            out[cname] = {"groups": list(gnames),
                          "members": [list(pidx[g]) for g in gnames]}
    return out


def _on_disk(leaf):
    """(host copy of ``leaf`` in its on-disk form, manifest dtype name). The
    copy never shares memory with the leaf, so a later in-place update
    cannot reach an asynchronous write."""
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2"), "bfloat16"
    a = t.numpy()
    if a.dtype == np.int64:
        if a.size and (a.min() < 0 or a.max() > MASK):
            raise ValueError("int64 leaves hold uint32 words; a value lies "
                             "outside [0, 2**32)")
        a = a.astype(np.uint32)
    return a, str(a.dtype)


def _crc(arr: np.ndarray) -> int:
    """zlib.crc32 of the array's bytes (``arr.tobytes()``), without a copy."""
    return zlib.crc32(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


def _write_npz(path: str, chunk: Dict[str, tuple]) -> None:
    """``np.savez(path, **arrays)``, member for member, except that a
    bfloat16 leaf gets the header an ml_dtypes array gets (``<V2``)."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, (arr, dtype) in chunk.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                if dtype == "bfloat16":
                    np.lib.format.write_array_header_1_0(
                        f, {"descr": _BF16_DESCR, "fortran_order": False,
                            "shape": arr.shape})
                    f.write(np.ascontiguousarray(arr).tobytes())
                else:
                    np.lib.format.write_array(f, arr, allow_pickle=False)


def save(tree, directory: str, step: int, *, asynchronous: bool = False,
         extra: Optional[Dict[str, Any]] = None) -> Optional[threading.Thread]:
    """Write a checkpoint of ``tree`` (``None`` slots skipped). Every leaf is
    copied to host memory before this returns; with ``asynchronous=True``
    the files are written on a daemon thread, which is returned.

    ``extra``: JSON-serializable keys merged into manifest.json (e.g. the
    ``gdc_signatures`` that ``repro_torch.lifetime`` compares against);
    the layout's own keys cannot be overridden."""
    host = {k: _on_disk(v) for k, v in flatten_with_path(tree)}
    tile_groups = _tile_group_manifest(tree)
    tile_classes = _tile_class_manifest(tree)
    extra = dict(extra or {})
    if set(extra) & _RESERVED:
        raise ValueError(f"extra manifest keys collide with layout keys: "
                         f"{set(extra) & _RESERVED}")

    def _write():
        # unique tmp dir: an async save and a final sync save of the same
        # step must not collide
        tmp = os.path.join(directory, f".tmp_step_{step:09d}_{os.getpid()}_"
                                      f"{threading.get_ident()}")
        final = os.path.join(directory, f"step_{step:09d}")
        os.makedirs(tmp, exist_ok=True)
        manifest: Dict[str, Any] = {"step": step, "time": time.time(),
                                    "layout": 4, "arrays": {}}
        if tile_groups:
            manifest["tile_groups"] = tile_groups
        if tile_classes:
            manifest["tile_classes"] = tile_classes
        manifest.update(extra)
        chunk_idx, chunk, chunk_bytes = 0, {}, 0

        def flush():
            nonlocal chunk_idx, chunk, chunk_bytes
            if not chunk:
                return
            _write_npz(os.path.join(tmp, f"arrays_{chunk_idx:03d}.npz"), chunk)
            chunk_idx += 1
            chunk, chunk_bytes = {}, 0

        for key, (arr, dtype) in sorted(host.items()):
            safe = npz_key(key)
            manifest["arrays"][key] = {
                "shape": list(arr.shape),
                "dtype": dtype,
                "file": f"arrays_{chunk_idx:03d}.npz",
                "npz_key": safe,
                "crc32": _crc(arr),
            }
            chunk[safe] = (arr, dtype)
            chunk_bytes += arr.nbytes
            if chunk_bytes >= _CHUNK_BYTES:
                flush()
        flush()
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            os.rename(final, final + f".old_{os.getpid()}_{threading.get_ident()}")
        try:
            os.rename(tmp, final)
        except OSError:
            # another writer won the race for this step; ours is equivalent
            shutil.rmtree(tmp, ignore_errors=True)
        latest = os.path.join(directory, "latest")
        tmp_link = latest + ".tmp"
        if os.path.lexists(tmp_link):
            os.remove(tmp_link)
        os.symlink(os.path.basename(final), tmp_link)
        os.replace(tmp_link, latest)

    if asynchronous:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    return None


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and ".old" not in d]
    return max(steps) if steps else None


def _step_dir(directory: str, step: Optional[int]) -> str:
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    return os.path.join(directory, f"step_{step:09d}")


def read_manifest(directory: str, step: Optional[int] = None) -> Dict[str, Any]:
    """manifest.json of ``step`` (default: the latest): the stored plan and
    the ``extra`` keys, without reading any array."""
    with open(os.path.join(_step_dir(directory, step), "manifest.json")) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# the re-key matrix: assemble a template leaf from another tile layout
# ---------------------------------------------------------------------------


def _legacy_group_members(manifest, shape, dtype_name, tag=""):
    """Member weight-paths of one tile group in a legacy per-tile
    checkpoint, sorted (``group_tiles``' stacking order). A non-empty
    ``tag`` keeps only paths whose sharding-rule template matches."""
    members = []
    for key, meta in manifest["arrays"].items():
        m = re.match(r"^tiles/(.+)/W$", key)
        if m and tuple(meta["shape"]) == tuple(shape) \
                and meta["dtype"] == dtype_name:
            members.append(m.group(1))
    if tag:
        members = [p for p in members
                   if template_tag(rule_template(p, len(shape))) == tag]
    return sorted(members)


def _bank_member_index(template):
    """{group name: member weight-paths} of every TileBank in ``template``."""
    return {g: tuple(paths) for bank in _banks(template)
            for g, paths in bank.index}


def _legacy_grouped_arr(key, manifest, load_arr, bank_members):
    """Assemble a grouped-layout leaf ``tiles/<group>/<slot>`` missing from
    the manifest from an older layout: per-tile checkpoints (stack the
    members in group order); coarser-keyed stacks, (shape, dtype)-only or
    without the policy tag (gather this group's rows, in the order of the
    checkpoint's own ``tile_groups`` members where it has them, else of
    the template's union); any other regrouping the v3 member map
    describes (member by member from each tile's stored (group, row)).
    Returns None when ``key`` is not a grouped tile leaf."""
    m = re.match(r"^tiles/([^/]+)/(.+)$", key)
    if not m:
        return None
    gname = m.group(1)
    parsed = parse_group_name(gname)
    if parsed is None:
        return None
    shape, dtype_name, tag, _ptag = parsed
    slot = m.group(2)
    manifest_groups = manifest.get("tile_groups", {})
    members = bank_members.get(gname) \
        or manifest_groups.get(gname, {}).get("members") \
        or _legacy_group_members(manifest, shape, dtype_name, tag)
    if not members:
        return None
    # 1) per-tile legacy layout
    if f"tiles/{members[0]}/{slot}" in manifest["arrays"]:
        return torch.stack([load_arr(f"tiles/{p}/{slot}") for p in members])
    # 2) coarser-keyed grouped layouts, most specific first: without the
    # policy tag (pre-AnalogPlan), then (shape, dtype) only
    candidates = []
    for cand in (group_name(shape, dtype_name, tag),
                 group_name(shape, dtype_name)):
        if cand != gname and cand not in candidates:
            candidates.append(cand)
    for src in candidates:
        if f"tiles/{src}/{slot}" not in manifest["arrays"]:
            continue
        old_members = manifest_groups.get(src, {}).get("members")
        if old_members is None:
            # pre-v3 manifest: the old member set is the sorted union of the
            # template's groups that the old key covered (same model)
            sshape, sdt, sttag, _ = parse_group_name(src)
            old_members = sorted(
                p for g, paths in bank_members.items() for p in paths
                if (lambda pg: pg is not None and pg[0] == sshape
                    and pg[1] == sdt
                    and (not sttag or pg[2] == sttag))(parse_group_name(g)))
        if not all(p in old_members for p in members):
            continue
        old = load_arr(f"tiles/{src}/{slot}")
        if old.shape[0] != len(old_members):
            raise ValueError(
                f"legacy group {src} holds {old.shape[0]} tiles but its "
                f"member list names {len(old_members)}: {old_members}")
        return old[[old_members.index(p) for p in members]]
    # 3) cross-plan re-key through the v3 member map
    path_src: Dict[str, tuple] = {}
    for src, rec in manifest_groups.items():
        if f"tiles/{src}/{slot}" not in manifest["arrays"]:
            continue
        for row, p2 in enumerate(rec.get("members") or ()):
            path_src.setdefault(p2, (src, row))
    if not all(p in path_src for p in members):
        return None
    loaded: Dict[str, Any] = {}  # each source stack is read once
    rows = []
    for p in members:
        src, row = path_src[p]
        if src not in loaded:
            loaded[src] = load_arr(f"tiles/{src}/{slot}")
        rows.append(loaded[src][row])
    return torch.stack(rows)


def _group_view(manifest, load_arr):
    """Per-group view of a v4 class-keyed checkpoint: ``(manifest',
    load_arr')`` in which every ``tiles/<group>/<slot>`` of every class
    member exists as a virtual array (row ``ci`` of its class stack), so
    the pre-v4 re-keys work against a v4 source unchanged. Checkpoints
    without ``tile_classes`` pass through."""
    classes = manifest.get("tile_classes")
    if not classes:
        return manifest, load_arr
    arrays = dict(manifest["arrays"])
    virtual: Dict[str, tuple] = {}
    for key, meta in manifest["arrays"].items():
        m = re.match(r"^tiles/([^/]+)/(.+)$", key)
        if not m or m.group(1) not in classes:
            continue
        cname, slot = m.group(1), m.group(2)
        for ci, g in enumerate(classes[cname]["groups"]):
            gkey = f"tiles/{g}/{slot}"
            # single-group classes (cname == g) are overridden too: the
            # group view always has the (n, *member) member shape
            virtual[gkey] = (key, ci)
            arrays[gkey] = {**meta, "shape": list(meta["shape"][1:])}
    man2 = dict(manifest)
    man2["arrays"] = arrays

    def load2(key):
        v = virtual.get(key)
        if v is None:
            return load_arr(key)
        return load_arr(v[0])[v[1]]

    return man2, load2


def _class_arr(key, manifest, load_arr, bank_members):
    """Assemble a v4 class leaf ``tiles/<class>/<slot>`` not stored under its
    own key by stacking its member groups, each from a same-name v3 stack,
    a re-keyed older layout or a slice of another v4 partition. Returns
    None when ``key`` is not a class leaf or a member cannot be built."""
    m = re.match(r"^tiles/([^/]+)/(.+)$", key)
    if not m:
        return None
    cname, slot = m.group(1), m.group(2)
    groups = parse_class_name(cname)
    if any(parse_group_name(g) is None for g in groups):
        return None
    gman, gload = _group_view(manifest, load_arr)
    parts = []
    for g in groups:
        gkey = f"tiles/{g}/{slot}"
        if gkey in gman["arrays"]:
            arr = gload(gkey)
        else:
            arr = _legacy_grouped_arr(gkey, gman, gload, bank_members)
        if arr is None:
            return None
        parts.append(arr)
    return torch.stack(parts)


def _policy_json_matches(new, stored) -> bool:
    """Only keys the checkpoint recorded constrain the match, so TileConfig
    and DeviceConfig fields added after it was written compare as their
    defaults."""
    if isinstance(new, dict) and isinstance(stored, dict):
        return all(_policy_json_matches(new.get(k), v)
                   for k, v in stored.items())
    return new == stored


def _warn_policy_mismatch(template, manifest) -> None:
    """ONE warning listing every template stack whose TilePolicy differs
    from the one the checkpoint records for it (v3+ manifests). A group
    absent under its own name compares against the coarser key it would
    re-key from, or the finer policy-split stacks that cover it."""
    stored = manifest.get("tile_groups", {})
    if not stored:
        return

    def stored_policies(g):
        if g in stored:
            return [stored[g].get("policy")]
        parsed = parse_group_name(g)
        if parsed is None:
            return []
        shape, dtype_name, tag, _ptag = parsed
        for cand in (group_name(shape, dtype_name, tag),
                     group_name(shape, dtype_name)):
            if cand in stored:
                return [stored[cand].get("policy")]
        return [rec.get("policy") for g2, rec in stored.items()
                if (parse_group_name(g2) or (None,) * 3)[:3]
                == (shape, dtype_name, tag)]

    mismatched = []
    for bank in _banks(template):
        for g, _ in bank.index:
            pol = bank.policy(g)
            if pol is None:
                continue
            for rec in stored_policies(g):
                if rec is not None and not _policy_json_matches(
                        policy_to_json(pol), rec):
                    mismatched.append(f"{g} ({rec.get('name') or rec.get('tag')}"
                                      f" -> {pol.name or pol.tag})")
                    break
    if mismatched:
        warnings.warn(
            f"{len(mismatched)} tile stack(s) restore under a different "
            f"policy than the one they were trained with: "
            f"{'; '.join(mismatched)}",
            stacklevel=3)


# ---------------------------------------------------------------------------
# restore
# ---------------------------------------------------------------------------


def _as_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """An on-disk array as the port's tensor (host memory)."""
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    if arr.dtype == np.uint32:
        return torch.from_numpy(arr.astype(np.int64))
    return torch.from_numpy(arr)


def _leaf_device(path: str, leaf, device, host_leaves):
    if device is not None and path.rsplit("/", 1)[-1] not in host_leaves:
        return torch.device(device)
    return leaf.device


def restore(template, directory: str, step: Optional[int] = None, *,
            device=None, host_leaves: Sequence[str] = (),
            verify: bool = False, shardings=None):
    """Load ``step`` (default: the latest) into the structure of
    ``template``. Each leaf lands where its template leaf lives (the
    tensor's or the ``TensorSpec``'s device); ``device`` moves every leaf
    but those whose last path component is in ``host_leaves`` (for a
    trainer state, ``trainer.HOST_LEAVES``: key, step, tile seeds).
    ``verify`` checks every array read against its crc32. A stored policy
    that differs from the template's is reported in one warning (legal,
    but usually a mistake). ``shardings`` (elastic restore onto a mesh) is
    not ported yet."""
    if shardings is not None:
        raise NotImplementedError(
            "shardings= is not ported yet; the port restores onto one device")
    d = _step_dir(directory, step)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    _warn_policy_mismatch(template, manifest)
    files: Dict[str, Any] = {}

    def load_arr(key) -> torch.Tensor:
        meta = manifest["arrays"][key]
        fname = meta["file"]
        if fname not in files:
            files[fname] = np.load(os.path.join(d, fname))
        arr = files[fname][meta["npz_key"]]
        if verify and _crc(arr) != meta["crc32"]:
            raise ValueError(f"corrupt leaf {key}: crc32 mismatch")
        return _as_tensor(arr, meta["dtype"])

    bank_members = _bank_member_index(template)
    out: Dict[str, torch.Tensor] = {}
    try:
        for key, leaf in flatten_with_path(template):
            expect = tuple(leaf.shape)
            if key in manifest["arrays"] and \
                    tuple(manifest["arrays"][key]["shape"]) == expect:
                arr = load_arr(key)
            else:
                arr = _class_arr(key, manifest, load_arr, bank_members)
                if arr is None:
                    arr = _legacy_grouped_arr(key, manifest, load_arr,
                                              bank_members)
                if arr is None and key in manifest["arrays"]:
                    arr = load_arr(key)  # the shape check reports it
                if arr is None:
                    raise KeyError(f"checkpoint missing leaf {key}")
            if tuple(arr.shape) != expect:
                raise ValueError(f"leaf {key}: checkpoint shape "
                                 f"{tuple(arr.shape)}, template {expect}")
            out[key] = arr.to(_leaf_device(key, leaf, device, host_leaves))
    finally:
        for z in files.values():
            z.close()
    return tree_map_with_path(
        lambda p, leaf: None if leaf is None else out[p], template,
        keep_none=True)

