"""Serving artifacts: the packet-trace program with its compiled kernel.

rtk_tpu.utils.aot serializes the jitted trace program as StableHLO with a
flat signature and pinned shapes, so that a server pays file reads and no
Python tracing; utils/serialize.py round-trips the data.  Here the program
is this module's pinned front end and the CUDA kernel library, and what
takes time at start-up is nvcc.  So the artifact carries the library
itself: the .so that ops/library.kernel_library built for the trace's
keywords (a jit_filter's own build when it has one), which holds the
traversal, the sorted front end's coherence key, rows pass and unsort,
the refit and repack that a refit artifact runs on the card, and the
instance candidate slab.  A server writes it under the package's build
directory by its hash, loads it with ctypes and calls it; it never calls
nvcc.

The flat signatures are the reference's:

  export_packet_trace:  (nodes, tris, origin, direction, min_t, max_t)
                        -> (hit, t, u, v, slot)
  export_refit_trace:   (tri_pos, origin, direction, min_t, max_t)
                        -> (hit, t, u, v, slot, tri_v)

Their shapes and dtypes are pinned at export, and a call with other shapes
raises ValueError.  The node and triangle tables are arguments, so one
trace artifact serves every scene with the same table shapes (every frame
of a refit clip); the refit artifact bakes in the topology (the Scene and
the PackedScene).

An artifact is a serialize.py container (no pickle) of kind KIND_TRACE or
KIND_REFIT; meta ints (AOT_VERSION, n_rays); a UTF-8 JSON section
"aot.json" with the mode, the trace keywords, the platforms, the pinned
signature and the library's file name (which carries the hash of its
sources and nvcc flags) and sha256 (a filter is stored as its
captured expression, ops/filter_capture.predicate_nodes); the library's
bytes in "aot.lib" when "cuda" is among the platforms; and, for the refit
artifact, the Scene's and the PackedScene's sections under "s." and "p.".
Loading refuses a wrong magic, container version, kind or AOT_VERSION.
"""
from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os
from typing import Sequence

import numpy as np
import torch

from rtk_tpu_torch.ops import library
from rtk_tpu_torch.ops import packet_trace as pt
from rtk_tpu_torch.ops.filter_capture import (predicate_from_nodes,
                                              predicate_nodes)
from rtk_tpu_torch.scene import Scene
from rtk_tpu_torch.trace.packed import PackedScene
from rtk_tpu_torch.types import PacketHits, Rays
from rtk_tpu_torch.utils import serialize as ser
from rtk_tpu_torch.utils.build import BUILD_DIR

# Artifact version: bump when the flat call signature or the entry points
# of the embedded library change.  2: the library holds rtk_ray_rows, which
# a version-1 library lacks; 3: it holds rtk_shade (render_path's shade
# pass), which a version-2 library lacks; 4: it holds the refit and repack
# (csrc/refit.cu: rtk_refit_parents, rtk_refit_leaves, rtk_refit_slots,
# rtk_repack), which a version-3 library lacks; 5: it holds the instance
# candidate slab (csrc/candidates.cu: rtk_instance_candidates), which a
# version-4 library lacks; 6: it holds an instanced round's object rays
# and hit scatter (csrc/rounds.cu: rtk_instanced_round_rays,
# rtk_instanced_round_scatter), which a version-5 library lacks.  An
# artifact of another version is refused before the loader binds it.
AOT_VERSION = 6
KIND_TRACE = 16  # container kinds of this module (serialize.py has 0-2)
KIND_REFIT = 17
PLATFORMS = ("cpu", "cuda")

# trace_packets' keywords an artifact pins (the reference's **trace_kw).
# stats and the root arrays change the flat signature and are refused.
TRACE_KW = ("watertight", "interpret", "p_pk", "hbm_tris", "dual", "pkt",
            "narrow", "sort_rays", "ordered", "islab", "lesion",
            "filter_mask", "filter_fn", "kz_static", "tris128", "leaf_loop",
            "defer_uv")
REFIT_KW = ("watertight", "interpret", "p_pk", "hbm_tris", "dual", "pkt",
            "narrow", "sort_rays", "ordered", "islab", "leaf_loop",
            "defer_uv")
_F32, _I32 = "float32", "int32"


def _platforms(platforms, device) -> list:
    out = [device.type] if platforms is None else list(platforms)
    bad = [p for p in out if p not in PLATFORMS]
    if bad or not out:
        raise ValueError(f"platforms must be among {PLATFORMS}, not {out}")
    return out


def _trace_kw(packed: PackedScene, mode: str, trace_kw: dict, allowed,
              checked):
    """Check the keywords as the front end does (`checked`: the flags it
    passes to _check_flags) -> (JSON-ready keywords, the filter or
    None)."""
    extra = sorted(set(trace_kw) - set(allowed))
    if extra:
        raise ValueError(f"an artifact cannot pin {extra}: its flat "
                         "signature has no place for them")
    if mode not in ("closest", "any"):
        raise ValueError(f"unknown mode {mode!r}")
    pt._check_flags(packed, **{k: trace_kw.get(k) for k in checked})
    kw = dict(trace_kw)
    flt = kw.pop("filter_fn", None)
    if flt is not None:
        pt._require_captured(flt)
        kw["filter_fn"] = predicate_nodes(flt.expr)
    return kw, flt


def _library(platforms, flt):
    """(name, bytes) of the kernel library for `flt` when "cuda" is among
    the platforms (built with nvcc at first use; no card needed)."""
    if "cuda" not in platforms:
        return None, b""
    so, _ = library.kernel_library(flt)
    return so.name, so.read_bytes()


def _signature(args) -> dict:
    return {"in_shapes": [list(a) for a, _ in args],
            "in_dtypes": [d for _, d in args]}


def _export(kind, spec, lib, arrays, n_rays) -> bytes:
    spec = {**spec, "library": None if lib[0] is None else {
        "name": lib[0], "sha256": hashlib.sha256(lib[1]).hexdigest()}}
    sections = {"aot.json": np.frombuffer(json.dumps(spec).encode(),
                                          np.uint8)}
    if lib[0] is not None:
        sections["aot.lib"] = np.frombuffer(lib[1], np.uint8)
    sections.update(arrays)
    buf = io.BytesIO()
    ser._save_container(kind, sections, (AOT_VERSION, n_rays), buf)
    return buf.getvalue()


def export_packet_trace(packed: PackedScene, n_rays: int,
                        mode: str = "closest",
                        platforms: Sequence[str] | None = None,
                        **trace_kw) -> bytes:
    """Serialize the packet-trace program for `packed`'s table shapes and
    n_rays rays.

    The flat signature is ``(nodes, tris, origin, direction, min_t, max_t)
    -> (hit, t, u, v, slot)``; the tables ride as arguments, so one
    artifact serves any scene with the same table shapes, width and leaf
    size.  trace_kw: trace_packets' keywords (filter_fn a jit_filter
    predicate), checked as trace_packets checks them.

    platforms: where the artifact runs, among "cpu" and "cuda" (default:
    the tables' device).  With "cuda" the kernel library is built (nvcc,
    no card needed: the counterpart of the reference's export for "tpu"
    from a CPU host) and embedded; "cpu" alone embeds none and runs the
    plain version.
    """
    platforms = _platforms(platforms, packed.device)
    kw, flt = _trace_kw(packed, mode, trace_kw, TRACE_KW, (
        "pkt", "narrow", "kz_static", "tris128", "leaf_loop", "hbm_tris"))
    spec = {"mode": mode, "trace_kw": kw, "platforms": platforms,
            "leaf_size": packed.leaf_size, "branching": packed.branching,
            **_signature([(tuple(packed.nodes.shape), _I32),
                          (tuple(packed.tris.shape), _F32),
                          ((n_rays, 3), _F32), ((n_rays, 3), _F32),
                          ((n_rays,), _F32), ((n_rays,), _F32)])}
    return _export(KIND_TRACE, spec, _library(platforms, flt), {}, n_rays)


def export_refit_trace(packed: PackedScene, scene: Scene, n_rays: int,
                       mode: str = "closest",
                       platforms: Sequence[str] | None = None,
                       **trace_kw) -> bytes:
    """Serialize the fused refit + repack + trace program of a deforming
    scene (trace_packets_refit).

    Flat signature: ``(tri_pos, origin, direction, min_t, max_t) -> (hit,
    t, u, v, slot, tri_v)``, tri_pos the frame's (T, 3, 3) vertices in
    soup order.  The topology (`scene`, the LBVH Scene that `packed` was
    packed from, and `packed`) is baked into the artifact; the returned
    tri_v is the frame's repacked vertex table.  trace_kw:
    trace_packets_refit's keywords; platforms as export_packet_trace.
    """
    if not isinstance(scene, Scene):
        raise TypeError("export_refit_trace bakes in an LBVH Scene; a "
                        f"{type(scene).__name__} has no container section")
    platforms = _platforms(platforms, packed.device)
    kw, _ = _trace_kw(packed, mode, trace_kw, REFIT_KW,
                      ("narrow", "leaf_loop", "hbm_tris"))
    spec = {"mode": mode, "trace_kw": kw, "platforms": platforms,
            "scene_meta": [scene.num_tris, scene.leaf_size, scene.branching,
                           scene.num_leaves, int(scene.has_wide)],
            "packed_meta": [packed.num_tris, packed.leaf_size,
                            packed.branching, packed.depth],
            **_signature([((scene.num_tris, 3, 3), _F32),
                          ((n_rays, 3), _F32), ((n_rays, 3), _F32),
                          ((n_rays,), _F32), ((n_rays,), _F32)])}
    arrays = {"s." + n: getattr(scene, n) for n in ser._FIELDS}
    arrays.update({"p." + n: getattr(packed, n) for n in ser._PACKED_FIELDS})
    return _export(KIND_REFIT, spec, _library(platforms, None), arrays,
                   n_rays)


def _check_card(dev: torch.device):
    major, minor = torch.cuda.get_device_capability(dev)
    if (major, minor) != (9, 0):
        raise RuntimeError(
            f"the artifact's kernel is built for sm_90a; "
            f"{torch.cuda.get_device_name(dev)} is sm_{major}{minor}")


class _Artifact:
    """What both loaders share: the spec, the pinned signature, and the
    front end's steps (the embedded library's kernels, or the plain
    versions)."""

    def __init__(self, blob: bytes, kind: int, what: str):
        got, arrays, meta = ser._load_container(bytes(blob))
        if got != kind:
            raise ValueError(f"artifact holds kind {got}, not {what}")
        if not meta or meta[0] != AOT_VERSION:
            raise ValueError(f"unsupported artifact version "
                             f"{meta[0] if meta else None}")
        spec = json.loads(arrays.pop("aot.json").tobytes())
        self._spec, self._arrays = spec, arrays
        self.mode = spec["mode"]
        self.platforms = tuple(spec["platforms"])
        self.in_shapes = tuple(tuple(s) for s in spec["in_shapes"])
        self.trace_kw = dict(spec["trace_kw"])
        nodes = self.trace_kw.pop("filter_fn", None)
        self._filter = None if nodes is None else predicate_from_nodes(nodes)
        self._lib = self._card = None
        if spec["library"] is not None:
            self._lib = self._load_library(spec["library"],
                                           arrays.pop("aot.lib").tobytes())
            self._card = pt.Steps.of(self._lib)

    def _load_library(self, info, data: bytes):
        """Write the embedded library under its hash (atomically, once)
        and load it; nvcc is never called.  Raises on a card that sm_90a
        cannot run."""
        sha = hashlib.sha256(data).hexdigest()
        if sha != info["sha256"]:
            raise ValueError("the artifact's kernel library is corrupt "
                             "(sha256 mismatch)")
        if torch.cuda.is_available():
            _check_card(torch.device("cuda"))
        path = BUILD_DIR / f"libpacket_trace_aot-{sha[:16]}.so"
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_name(f"{path.name}.tmp{os.getpid()}")
            tmp.write_bytes(data)
            os.replace(tmp, path)
        return library.bind_library(path, march=self._filter is None)

    @property
    def n_rays(self) -> int:
        return self.in_shapes[-1][0]

    def _check_args(self, args):
        """The call's arrays against the pinned signature (what jax.export
        checks for the reference) -> the front end's steps for their
        device: on the card the embedded library's kernels, on the CPU the
        plain versions."""
        for i, (a, shape, dt) in enumerate(zip(
                args, self.in_shapes, self._spec["in_dtypes"])):
            a = torch.as_tensor(a)
            if tuple(a.shape) != shape or str(a.dtype) != f"torch.{dt}":
                raise ValueError(
                    f"argument {i} is {tuple(a.shape)} {a.dtype}; the "
                    f"artifact was exported for {shape} {dt}")
        dev = torch.as_tensor(args[-1]).device
        if dev.type not in self.platforms:
            raise ValueError(f"the artifact was exported for "
                             f"{list(self.platforms)}, not {dev.type}")
        if dev.type == "cuda":
            _check_card(dev)
        return pt.front_steps(dev, card=self._card)


class LoadedTrace(_Artifact):
    """A loaded packet-trace artifact; call with (packed, rays).

    The packed scene supplies the kernel tables (checked against the
    pinned shapes, width and leaf size) and the hit-assembly tables of the
    returned PacketHits."""

    def __init__(self, blob: bytes):
        super().__init__(blob, KIND_TRACE, "a packet-trace artifact")

    def __call__(self, packed: PackedScene, rays: Rays) -> PacketHits:
        steps = self._check_args((packed.nodes, packed.tris, rays.origin,
                                  rays.direction, rays.min_t, rays.max_t))
        if (packed.leaf_size, packed.branching) != (
                self._spec["leaf_size"], self._spec["branching"]):
            raise ValueError(
                f"tables of leaf size {packed.leaf_size} and width "
                f"{packed.branching}; the artifact was exported for "
                f"{self._spec['leaf_size']} and {self._spec['branching']}")
        kw = self.trace_kw
        return pt._front(steps, packed, rays, self.mode,
                         kw.get("watertight", True), kw.get("sort_rays"),
                         kw.get("filter_mask"), kw.get("defer_uv", False),
                         None, self._filter)


def load_packet_trace(blob: bytes) -> LoadedTrace:
    """Load an export_packet_trace artifact (no build: an embedded kernel
    library is loaded as it is)."""
    return LoadedTrace(blob)


class LoadedRefitTrace(_Artifact):
    """A loaded refit + trace artifact; call with (packed, tri_pos, rays).
    `packed` supplies only the hit-assembly index tables (tri_vidx,
    tri_mesh, tri_prim: the slot mapping is the same for every frame); the
    frame's vertex table comes back from the artifact."""

    def __init__(self, blob: bytes):
        super().__init__(blob, KIND_REFIT, "a refit-trace artifact")
        self._tables = {}

    def _topology(self, dev):
        """The baked Scene and PackedScene on `dev` (copied once)."""
        if dev not in self._tables:
            a = {k: torch.as_tensor(v, device=dev)
                 for k, v in self._arrays.items()}
            scene = ser._scene_from(
                {k[2:]: v for k, v in a.items() if k.startswith("s.")},
                self._spec["scene_meta"])
            num_tris, leaf_size, branching, depth = self._spec["packed_meta"]
            packed = PackedScene(
                num_tris=num_tris, leaf_size=leaf_size, branching=branching,
                depth=depth, **{n: a["p." + n] for n in ser._PACKED_FIELDS})
            self._tables[dev] = scene, packed
        return self._tables[dev]

    def __call__(self, packed: PackedScene, tri_pos, rays: Rays
                 ) -> PacketHits:
        steps = self._check_args((tri_pos, rays.origin, rays.direction,
                                  rays.min_t, rays.max_t))
        scene, baked = self._topology(rays.device)
        kw = self.trace_kw
        hits, _, _ = pt._refit_trace(steps, baked, scene, tri_pos, rays,
                                     self.mode, kw.get("watertight", True),
                                     kw.get("sort_rays"),
                                     kw.get("defer_uv", False))
        return dataclasses.replace(hits, tri_vidx=packed.tri_vidx,
                                   tri_mesh=packed.tri_mesh,
                                   tri_prim=packed.tri_prim)


def load_refit_trace(blob: bytes) -> LoadedRefitTrace:
    return LoadedRefitTrace(blob)
