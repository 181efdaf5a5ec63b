"""render_path over an instanced scene (instancing.py::InstancedTracer):
four instances of a small icosphere, each rotated, scaled unevenly and
moved, against the plain instanced path tracer
(testing/instanced_path_reference.py); the source's closest against the
reference's brute force over every instance; the world-space normal of an
instanced record; and the flat record's shade path as it was."""
import dataclasses
import math

import numpy as np
import pytest
import torch

import rtk_tpu_torch as rt
from rtk_tpu_torch import instancing
from rtk_tpu_torch.models import path as tpath
from rtk_tpu_torch.testing import instanced_path_reference as ipr
from rtk_tpu_torch.testing import scenes

torch.set_num_threads(2)

BOUNCES = 2
BACKGROUND = (0.2, 0.3, 0.4)
EPSILON = 1e-3
ALBEDO = [[0.7, 0.6, 0.5]]
EMISSION = [[0.05, 0.1, 0.0]]
TOL = 1e-4  # a path agrees within TOL * max(1, |L_ref|) in each channel
# (axis, angle, per-axis scale, translation) of each instance: a rotation,
# an uneven scale and a move each, the boxes overlapping so that a ray
# meets several instances.
INSTANCES = (((1, 0, 0), 0.4, (0.6, 0.3, 0.4), (-0.45, 0.0, 0.0)),
             ((0, 1, 0), 1.1, (0.3, 0.5, 0.35), (0.45, 0.1, 0.0)),
             ((1, 1, 0), 0.7, (0.45, 0.25, 0.5), (0.0, 0.45, -0.3)),
             ((0, 0, 1), 2.0, (0.5, 0.4, 0.2), (0.1, -0.45, 0.2)))


def _rotation(axis, angle):
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    k = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + math.sin(angle) * k + (1 - math.cos(angle)) * k @ k


def instanced_case(device="cpu", side=16, max_candidates=2):
    """The four instances of an icosphere(2) BLAS (320 triangles, LBVH
    leaf 8), their InstancedTracer (2 candidates a ray, so the residual
    re-traces some), Morton camera rays that see them all, the material,
    and seeded uniforms for BOUNCES bounces."""
    v, f = scenes.icosphere(2)
    soup = v[f].astype(np.float32)
    tf = np.zeros((len(INSTANCES), 3, 4), np.float32)
    for i, (axis, angle, scale, move) in enumerate(INSTANCES):
        tf[i, :, :3] = _rotation(axis, angle) @ np.diag(scale)
        tf[i, :, 3] = move
    blas = rt.build_from_soup(soup, config=rt.BuildConfig(leaf_size=8),
                              device=device)
    ps = rt.pack_instanced(rt.build_instanced(
        [blas], np.zeros(len(INSTANCES), np.int64), tf))
    rays = scenes.camera_rays((0.3, 0.4, 1.9), (0, 0, 0), (0, 1, 0), 50,
                              side, side, order="morton", device=device)
    g = torch.Generator().manual_seed(26)
    uniforms = torch.rand((BOUNCES, rays.count, 2), generator=g).to(device)
    return dict(soup=soup, tf=tf, pscene=ps,
                tracer=instancing.InstancedTracer(
                    ps, max_candidates=max_candidates),
                rays=rays, uniforms=uniforms,
                mats=tpath.Materials.make(ALBEDO, EMISSION, device=device))


@pytest.fixture(scope="module")
def case():
    return instanced_case()


def _render(c, tracer=None, **kw):
    return tpath.render_path(tracer or c["tracer"], c["rays"], c["mats"],
                             bounces=BOUNCES, background=BACKGROUND,
                             epsilon=EPSILON, uniforms=c["uniforms"], **kw)


def _reference(c):
    r = c["rays"]
    return ipr.render(c["soup"], c["tf"],
                      torch.zeros(c["soup"].shape[0], dtype=torch.int64),
                      c["mats"].albedo, c["mats"].emission, r.origin,
                      r.direction, r.min_t, r.max_t, c["uniforms"],
                      bounces=BOUNCES, background=BACKGROUND,
                      epsilon=EPSILON)


def _bad(got, want):
    return ((got - want).abs() > TOL * want.abs().clamp_min(1.0)).any(dim=1)


def test_closest_matches_the_brute_force(case):
    """The source's record against the reference's brute force over every
    instance: the same hits, instances and triangles; t within 4 float32
    ulps (the two inverses of the affines differ in their last bits, and
    the brute force divides where the traversal multiplies by a
    reciprocal).  The record carries the instance and the table."""
    r = case["rays"]
    hits = case["tracer"].closest(r)
    soup = torch.as_tensor(case["soup"])
    hit, t, row, inst = ipr.closest(
        soup, ipr.object_from_world(case["tf"]),
        ipr.world_boxes(soup, case["tf"]), r.origin, r.direction, r.min_t,
        r.max_t)
    assert 0.3 < float(hit.float().mean()) < 0.9
    assert torch.equal(hits.hit, hit)
    assert torch.equal(hits.instance.long(), inst)
    assert torch.equal(hits.triangle_index.long()[hit], row[hit])
    assert bool(((hits.t - t).abs() <= 4.8e-7 * t.abs())[hit].all())
    assert len(set(inst[hit].tolist())) == len(INSTANCES)
    assert hits.object_from_world is case["pscene"].iscene.object_from_world
    # A slice keeps each ray's instance.
    assert torch.equal(hits[5:9].instance, hits.instance[5:9])


@pytest.mark.parametrize("compact", [True, False])
def test_render_path_matches_the_reference(case, compact):
    """Every one of the 256 paths within TOL of the reference's and the
    mean radiance within 1e-5: the radiance of a sky-lit path is a product
    of albedos, the sky and the emission, so the few-ulp differences of t
    and of the normal (the inverses' last bits) move a path only where a
    ray grazes an edge or a silhouette, which none of these does."""
    got = _render(case, compact=compact)
    want = _reference(case)
    assert int(_bad(got, want).sum()) == 0
    assert abs(float(got.mean() / want.mean()) - 1.0) <= 1e-5
    # Paths escaped after 0, 1 and 2 hits, and some stayed on the objects.
    levels = set(torch.round(want[:, 2] / BACKGROUND[2], decimals=4).tolist())
    assert len(levels) >= 4


def test_object_space_normals_fail_the_reference(case):
    """The same frame shaded with the object-space normal (the record
    without its instance): many paths leave the reference's, so the
    reference sees the mapping."""

    class ObjectSpace(instancing.InstancedTracer):
        def closest(self, rays, coherent=None):
            return dataclasses.replace(super().closest(rays), instance=None,
                                       object_from_world=None)

    wrong = ObjectSpace(case["pscene"], max_candidates=2)
    bad = _bad(_render(case, tracer=wrong), _reference(case))
    assert float(bad.float().mean()) > 0.05


def test_instanced_normal_is_the_world_triangles(case):
    """The shade's normal of an instanced hit is perpendicular to the hit
    triangle's world-space edges (the object vertices through the
    instance's affine) and faces the ray: L^T n, not n."""
    r = case["rays"]
    hits = case["tracer"].closest(r)
    nrm = tpath.geometric_normal(hits, r.direction)
    h = hits.hit
    tf = torch.as_tensor(case["tf"]).double()[hits.instance.long()[h]]
    v = hits.vertex_position[h].double()
    world = torch.einsum("nab,nkb->nka", tf[:, :, :3], v) + tf[:, None, :, 3]
    n = nrm[h].double()
    for a, b in ((0, 1), (0, 2)):
        edge = world[:, b] - world[:, a]
        edge = edge / edge.norm(dim=1, keepdim=True)
        assert float((n * edge).sum(dim=1).abs().max()) < 1e-5
    assert float((n.norm(dim=1) - 1).abs().max()) < 1e-6
    assert bool(((n * r.direction[h].double()).sum(dim=1) <= 0).all())
    flat = tpath.geometric_normal(
        dataclasses.replace(hits, instance=None, object_from_world=None),
        r.direction)
    assert float((flat[h] - nrm[h]).abs().max()) > 0.1


def test_flat_record_shades_as_before():
    """A flat record takes the path it took before instanced records:
    geometric_normal is the normalised cross product of its own vertices
    bit for bit, and the kernel's arguments name no instance."""
    v, f = scenes.blob(2)[1:]
    tracer = rt.Tracer(rt.build_scene((v, f), device="cpu"))
    rays = scenes.camera_rays((0, 0, 3), (0, 0, 0), (0, 1, 0), 45, 16, 16,
                              device="cpu")
    hits = tracer.closest(rays)
    assert hits.instance is None and hits.object_from_world is None
    p = hits.vertex_position
    n = torch.linalg.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    n = n / torch.linalg.vector_norm(n, dim=1, keepdim=True).clamp_min(1e-20)
    n = torch.where((n * rays.direction).sum(dim=1, keepdim=True) > 0, -n, n)
    got = tpath.geometric_normal(hits, rays.direction)
    assert torch.equal(got.view(torch.int32), n.view(torch.int32))
    n_rays = rays.count
    args, _, _ = tpath._shade_args(
        hits, rays, torch.ones((n_rays, 3)), torch.arange(n_rays),
        torch.zeros((n_rays, 3)), tpath.Materials.make([[0.5] * 3],
                                                       device="cpu"),
        torch.zeros(3), tracer.scene.bounds_min, tracer.scene.bounds_max,
        epsilon=1e-4, sort_rays=True, last=False,
        draws=torch.rand((n_rays, 2)))
    assert (args.instance, args.object_from_world, args.instances) == (
        None, None, 0)


def test_source_bounds_are_the_instances_union(case):
    iscene = case["pscene"].iscene
    scene = case["tracer"].scene
    assert torch.equal(scene.bounds_min, iscene.inst_lo.amin(dim=0))
    assert torch.equal(scene.bounds_max, iscene.inst_hi.amax(dim=0))
    assert case["tracer"].max_candidates == 2
