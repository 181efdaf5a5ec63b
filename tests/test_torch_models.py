"""The render path of the port (models/path.py) against rtk_tpu's on the
CPU: the same seeded inputs and the reference's own uniforms through both
packages, at cornell-box size (16^2 to 32^2 rays, 2-3 bounces).  Each
tolerance is stated where it is used."""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rtk_tpu
import rtk_tpu_torch as rt
from rtk_tpu.models import path as jpath
from rtk_tpu.testing import scenes as jscenes
from rtk_tpu_torch.models import path as tpath
from rtk_tpu_torch.testing import carry, scenes

from test_torch_trace import CPU, _rays, _soup_of

torch.set_num_threads(2)

ALBEDO = [[0.7, 0.7, 0.7], [0.6, 0.3, 0.3], [0.0, 0.0, 0.0]]
EMISSION = [[0, 0, 0], [0, 0, 0], [15.0, 15.0, 15.0]]


def _meshes():
    """tests/test_models.py's scene: walls, boxes and an emissive quad
    just below the ceiling, as three meshes."""
    box = scenes.cornell_box()
    light = scenes.quad(*(np.array(p, np.float32) for p in (
        [0.35, 0.998, 0.35], [0.65, 0.998, 0.35], [0.65, 0.998, 0.65],
        [0.35, 0.998, 0.65])))
    return [_soup_of(m) for m in (box[:10], box[10:], light)]


@pytest.fixture(scope="module")
def both():
    """(rtk_tpu tracer and materials, the port's) over one scene."""
    j = rtk_tpu.Tracer(rtk_tpu.build_scene(_meshes()))
    t = rt.Tracer(rt.build_scene(_meshes(), device=CPU))
    return ((j, jpath.Materials.make(ALBEDO, EMISSION)),
            (t, carry.materials_from_arrays(ALBEDO, EMISSION, device=CPU)))


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_materials_make_equals_reference():
    j = jpath.Materials.make(ALBEDO, EMISSION)
    t = tpath.Materials.make(ALBEDO, EMISSION, device=CPU)
    np.testing.assert_array_equal(t.albedo.numpy(), np.asarray(j.albedo))
    np.testing.assert_array_equal(t.emission.numpy(), np.asarray(j.emission))
    flat = tpath.Materials.make(np.arange(6.0), device=CPU)
    assert flat.albedo.shape == (2, 3) and not flat.emission.any()
    # A tensor keeps its own device; arrays go to the card.
    assert tpath.Materials.make(torch.ones(1, 3)).albedo.device.type == "cpu"


def test_materials_default_to_the_card():
    assert inspect.signature(
        tpath.Materials.make).parameters["device"].default is None
    assert inspect.signature(
        carry.materials_from_arrays).parameters["device"].default \
        is inspect.Parameter.empty
    if torch.cuda.is_available():
        assert tpath.Materials.make(ALBEDO).albedo.device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            tpath.Materials.make(ALBEDO)


@pytest.mark.parametrize("n", [0, 1, 2, 3, 1023, 1024, 1025, 5000, 1 << 20,
                               (1 << 20) + 1])
def test_round_up_bucket_equals_reference(n):
    for minimum in (1, 1024):
        assert (tpath._round_up_bucket(n, minimum)
                == jpath._round_up_bucket(n, minimum))


def test_ray_sort_key_equals_reference():
    rng = np.random.default_rng(0)
    o = rng.uniform(-1.5, 2.5, (4096, 3)).astype(np.float32)
    d = rng.normal(size=(4096, 3)).astype(np.float32)
    d[:64] = np.abs(d[:64])  # the +++ octant: the key's top bits set
    d[64:96, 0] = 0.0  # a zero component counts as non-negative
    lo, hi = np.float32([-1, -1, -1]), np.float32([2, 2, 2])
    want = np.asarray(jpath._ray_sort_key(
        rtk_tpu.Rays.make(o, d), jnp.asarray(lo), jnp.asarray(hi)))
    got = tpath._ray_sort_key(rt.Rays.make(o, d, device=CPU),
                              torch.tensor(lo), torch.tensor(hi))
    assert got.dtype == torch.int32 and int(got.min()) >= 0
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    # The dead flag at bit 28 over the key's top 24 bits stays positive.
    assert int(((torch.ones_like(got) << 28) | (got >> 4)).min()) > 0


def _uniforms(k_dir, n):
    """The uniforms rtk_tpu's cosine_sample draws from k_dir
    (models/path.py:60-62)."""
    k1, k2 = jax.random.split(k_dir)
    return (np.array(jax.random.uniform(k1, (n,), jnp.float32)),
            np.array(jax.random.uniform(k2, (n,), jnp.float32)))


@pytest.mark.parametrize("sort_rays", [True, False])
def test_shade_sample_equals_reference(both, sort_rays):
    """One trace's hit records and the reference's uniforms through both
    _shade_samples: radiance, throughput and the next rays within 1e-6,
    alive and its count equal, perm equal wherever the sort keys are
    equal (at most 0.1% of the keys may differ: a Morton cell boundary
    moved by a last-bit difference in an origin)."""
    (jt, jm), (_, tm) = both
    jrays = jscenes.cornell_camera(32, 32)
    n = jrays.count
    rng = np.random.default_rng(1)
    thr = rng.uniform(0.2, 1.0, (n, 3)).astype(np.float32)
    thr[::7] = 1e-6  # paths the throughput cut ends
    index = rng.permutation(n).astype(np.int32)
    rad0 = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    bg = np.float32([0.1, 0.2, 0.3])
    k_dir = jax.random.PRNGKey(5)
    jh = jt.closest(jrays)
    jh = jh.full() if hasattr(jh, "full") else jh
    lo, hi = jt.scene.bounds_min, jt.scene.bounds_max
    kw = dict(epsilon=1e-4, sort_rays=sort_rays)
    want = jpath._shade_sample(jh, jrays, jnp.asarray(thr),
                               jnp.asarray(index), jnp.asarray(rad0), jm,
                               k_dir, jnp.asarray(bg), lo, hi, last=False,
                               **kw)
    want_last = jpath._shade_sample(jh, jrays, jnp.asarray(thr),
                                    jnp.asarray(index), jnp.asarray(rad0),
                                    jm, k_dir, jnp.asarray(bg), lo, hi,
                                    last=True, **kw)

    th = carry.hits_from_arrays(
        {f: np.asarray(getattr(jh, f)) for f in
         ("hit", "t", "u", "v", "mesh_index", "triangle_index",
          "vertex_position", "vertex_index")}, device=CPU)
    u1, u2 = _uniforms(k_dir, n)
    args = lambda: (th, _rays(jrays), torch.tensor(thr),  # noqa: E731
                    torch.tensor(index).long(), torch.tensor(rad0), tm, None,
                    torch.tensor(bg), torch.tensor(np.asarray(lo)),
                    torch.tensor(np.asarray(hi)))
    rad, nxt, thr2, perm, n_alive = tpath._shade_sample(
        *args(), last=False, u1=u1, u2=u2, **kw)
    tol = dict(rtol=0, atol=1e-6)
    np.testing.assert_allclose(rad.numpy(), np.asarray(want[0]), **tol)
    np.testing.assert_allclose(
        tpath._shade_sample(*args(), last=True, **kw).numpy(),
        np.asarray(want_last), **tol)
    np.testing.assert_allclose(thr2.numpy(), np.asarray(want[2]), **tol)
    for f in ("origin", "direction", "min_t", "max_t"):
        np.testing.assert_allclose(getattr(nxt, f).numpy(),
                                   np.asarray(getattr(want[1], f)), **tol)
    alive = nxt.max_t.numpy() > 0
    np.testing.assert_array_equal(alive, np.asarray(want[1].max_t) > 0)
    assert int(n_alive) == int(want[4]) == int(alive.sum())
    assert 0 < int(n_alive) < n
    # The permutation: each package's own key from its own next rays.
    dead = (~alive).astype(np.uint32)
    if sort_rays:
        jkey = (dead << 28) | (np.asarray(
            jpath._ray_sort_key(want[1], lo, hi)) >> 4)
        tkey = (dead << 28) | (tpath._ray_sort_key(
            nxt, torch.tensor(np.asarray(lo)),
            torch.tensor(np.asarray(hi))).numpy().astype(np.uint32) >> 4)
    else:
        jkey = tkey = dead
    differ = int((jkey != tkey).sum())
    assert differ <= 1e-3 * n, f"{differ} of {n} sort keys differ"
    if differ == 0:
        np.testing.assert_array_equal(perm.numpy(), np.asarray(want[3]))
    else:  # both sort their own keys stably
        np.testing.assert_array_equal(perm.numpy(),
                                      np.argsort(tkey, kind="stable"))


def test_render_direct_equals_reference(both):
    """Within 1e-5, outside rays whose two traces (rtk_tpu's stack engine,
    the port's packet engine) name different triangles at a tie; those
    are few (under 2% of the rays)."""
    (jt, jm), (tt, tm) = both
    jrays = jscenes.cornell_camera(32, 32)
    light = dict(light_pos=(0.5, 0.95, 0.5), light_color=(1.0, 1.0, 1.0))
    want = np.asarray(jpath.render_direct(jt, jrays, jm, **light))
    got = tpath.render_direct(tt, _rays(jrays), tm, **light)
    assert got.device.type == "cpu" and got.dtype == torch.float32
    same = (np.asarray(jt.closest(jrays).triangle_index)
            == tt.closest(_rays(jrays)).triangle_index.numpy())
    assert same.mean() > 0.98
    np.testing.assert_allclose(got.numpy()[same], want[same], rtol=0,
                               atol=1e-5)
    lum = got.numpy().max(axis=1)
    assert (lum < 1e-6).sum() > 10  # the boxes cast shadows


def _replay_draws(monkeypatch, key):
    """Make the port's cosine_sample draw what rtk_tpu draws from `key`:
    both render loops split the key once a draw and hand the second half
    to cosine_sample (models/path.py:177, :253)."""
    state = {"key": key}
    real = tpath.cosine_sample

    def replay(generator, normal, u1=None, u2=None):
        state["key"], k_dir = jax.random.split(state["key"])
        return real(None, normal, *_uniforms(k_dir, normal.shape[0]))

    monkeypatch.setattr(tpath, "cosine_sample", replay)


def test_render_path_replays_reference(both, monkeypatch):
    """compact=False, sort_rays=False, and the reference's uniforms
    replayed bounce by bounce through the port's draw: radiance within
    1e-4 on at least 99% of the rays (a ray whose hit point lies within
    rounding of an edge may bounce off another triangle)."""
    (jt, jm), (tt, tm) = both
    jrays = jscenes.cornell_camera(24, 24)
    key = jax.random.PRNGKey(3)
    kw = dict(bounces=3, background=(0.2, 0.3, 0.4), compact=False,
              sort_rays=False)
    want = np.asarray(jpath.render_path(jt, jrays, jm, key, **kw))
    _replay_draws(monkeypatch, key)
    got = tpath.render_path(tt, _rays(jrays), tm, None, **kw).numpy()
    close = (np.abs(got - want) <= 1e-4).all(axis=1)
    assert close.mean() >= 0.99, f"{close.mean():.4f} of the rays agree"
    assert np.isfinite(got).all() and got.max() > 0.01


def test_render_path_compacted_replays_reference(both, monkeypatch):
    """The compacted loop (the live count, the bucket, the take and the
    scatter through `index`) against the reference's, the uniforms
    replayed: radiance within 1e-4 on at least 99% of the rays.  Walls
    that absorb end most paths at once, and both packages' buckets start
    at 64 rays here in place of 1024, so the 32^2 batch shrinks at every
    bounce; sort_rays=False keeps the two permutations equal whenever the
    same rays are alive."""
    (jt, _), (tt, _) = both
    albedo = [[0.0, 0.0, 0.0], [0.8, 0.7, 0.6], [0.0, 0.0, 0.0]]
    emission = [[0.3, 0.2, 0.1], [0.0, 0.0, 0.0], [15.0, 15.0, 15.0]]
    jm = jpath.Materials.make(albedo, emission)
    tm = carry.materials_from_arrays(albedo, emission, device=CPU)
    sizes = []
    for mod in (jpath, tpath):
        real = mod._round_up_bucket
        monkeypatch.setattr(
            mod, "_round_up_bucket",
            lambda n, minimum, real=real: sizes.append(real(n, 64))
            or sizes[-1])
    jrays = jscenes.cornell_camera(32, 32)
    key = jax.random.PRNGKey(4)
    kw = dict(bounces=3, compact=True, sort_rays=False)
    want = np.asarray(jpath.render_path(jt, jrays, jm, key, **kw))
    _replay_draws(monkeypatch, key)
    got = tpath.render_path(tt, _rays(jrays), tm, None, **kw).numpy()
    close = (np.abs(got - want) <= 1e-4).all(axis=1)
    assert close.mean() >= 0.99, f"{close.mean():.4f} of the rays agree"
    # Both loops took the same buckets, and they shrank.
    half = len(sizes) // 2
    assert sizes[:half] == sizes[half:] and half >= 2
    assert sizes[0] < jrays.count and sizes[half - 1] < sizes[0]
    assert (got[:, 0] > 0.3 + 1e-3).sum() > 10  # paths that went on


def test_render_ao_replays_reference(both, monkeypatch):
    """render_ao with the reference's uniforms replayed sample by sample:
    equal exactly on at least 99% of the rays (a probe that grazes an
    edge, or a primary that names another triangle at a tie, may flip
    one sample)."""
    (jt, _), (tt, _) = both
    jrays = jscenes.cornell_camera(24, 24)
    key = jax.random.PRNGKey(6)
    kw = dict(samples=4, max_dist=0.5)
    want = np.asarray(jpath.render_ao(jt, jrays, key, **kw))
    _replay_draws(monkeypatch, key)
    got = tpath.render_ao(tt, _rays(jrays), None, **kw).numpy()
    assert (got == want).mean() >= 0.99, (got == want).mean()
    assert 0.05 < got.mean() < 0.99 and len(np.unique(got)) >= 3


@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("sort_rays", [True, False])
def test_furnace_identity(compact, sort_rays):
    """Albedo 1, emission e on every mesh and background e: each live ray
    traced adds exactly e and stays alive exactly when it hit, so
    radiance / e is a whole number in [1, bounces + 1] and its sum is the
    number of live rays traced over all bounces, counted here on its own
    by a tracer that wraps the real one.  Exact: small integers in f32."""
    e, bounces = 0.5, 3
    tris = scenes.blob(2)[0]  # an open scene: rays escape at every bounce
    tracer = rt.Tracer(rt.build_scene(_soup_of(tris), device=CPU))
    traced = []

    class Counting(rt.Tracer):
        def closest(self, rays, **kw):
            traced.append(int((rays.max_t > rays.min_t).sum()))
            return tracer.closest(rays, **kw)

    counting = Counting(tracer.scene)
    rays = scenes.camera_rays((0, 0, 3), (0, 0, 0), (0, 1, 0), 45, 32, 32,
                              device=CPU)
    mats = tpath.Materials.make(np.ones((1, 3)), np.full((1, 3), e),
                                device=CPU)
    rad = tpath.render_path(counting, rays, mats, _gen(0), bounces=bounces,
                            background=(e, e, e), compact=compact,
                            sort_rays=sort_rays)
    q = rad / e
    assert torch.equal(q, q.round())
    assert torch.equal(q[:, 0], q[:, 1]) and torch.equal(q[:, 0], q[:, 2])
    assert int(q.min()) >= 1 and int(q.max()) <= bounces + 1
    assert len(traced) >= 2 and traced[0] == rays.count
    assert 0 < traced[1] < rays.count  # some primaries hit, some escaped
    assert int(q[:, 0].sum()) == sum(traced)
    if compact:  # the buckets shrank
        assert traced[1] <= 1024


@pytest.mark.parametrize("engine",
                         ["stack", "march", "grid", "binned", "stackless"])
def test_render_path_bounce_tracer_matches(engine):
    """bounce_tracer (a second engine for the bounce batches) must not
    change radiance: the same scene, exact engines, the same random
    stream; rtol 1e-4, atol 1e-5 (tests/test_models.py:90-106)."""
    scene = rt.build_scene(_soup_of(scenes.cornell_box()), device=CPU)
    tracer = rt.Tracer(scene)
    mats = tpath.Materials.make([[0.7, 0.7, 0.7]], device=CPU)
    rays = scenes.cornell_camera(12, 12, device=CPU)
    kw = dict(bounces=2, background=(1.0, 1.0, 1.0))
    a = tpath.render_path(tracer, rays, mats, _gen(3), **kw)
    b = tpath.render_path(tracer, rays, mats, _gen(3),
                          bounce_tracer=rt.Tracer(scene, engine=engine), **kw)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-5)


# ---- the reference's own sanity tests (tests/test_models.py:35-87) ----

def test_path_tracer_converges_sane(both):
    tracer, mats = both[1]
    rays = scenes.cornell_camera(24, 24, device=CPU)
    gen = _gen(0)
    spp = 4
    img = sum(tpath.render_path(tracer, rays, mats, gen, bounces=3)
              for _ in range(spp)).numpy() / spp
    assert np.isfinite(img).all()
    assert img.max() > 0.01  # light reaches the camera
    assert (img >= 0).all()
    assert (img.max(axis=1) > 1e-4).mean() > 0.03


def test_path_compaction_matches_no_compaction(both):
    tracer, mats = both[1]
    rays = scenes.cornell_camera(16, 16, device=CPU)
    a = tpath.render_path(tracer, rays, mats, _gen(3), bounces=2,
                          compact=False).numpy()
    b = tpath.render_path(tracer, rays, mats, _gen(3), bounces=2,
                          compact=True, sort_rays=False).numpy()
    # Compaction permutes lanes, so per-ray samples differ; compare
    # aggregate statistics instead.
    assert abs(a.mean() - b.mean()) / max(a.mean(), 1e-9) < 0.35
    assert np.isfinite(b).all()


def test_render_direct_shadows(both):
    tracer, mats = both[1]
    rays = scenes.cornell_camera(32, 32, device=CPU)
    img = tpath.render_direct(tracer, rays, mats, light_pos=(0.5, 0.95, 0.5),
                              light_color=(1.0, 1.0, 1.0)).numpy()
    assert np.isfinite(img).all()
    assert img.max() > 0.01
    assert (img.max(axis=1) < 1e-6).sum() > 10


def test_render_ao(both):
    tracer, _ = both[1]
    rays = scenes.cornell_camera(16, 16, device=CPU)
    ao = tpath.render_ao(tracer, rays, _gen(1), samples=4,
                         max_dist=0.5).numpy()
    assert np.isfinite(ao).all()
    assert (ao >= 0).all() and (ao <= 1).all()
    assert 0.05 < ao.mean() < 0.99  # interior partially occluded


def test_render_entry_points_take_a_generator():
    """A torch.Generator stands where the reference takes its key; the
    other parameters keep the reference's names and order.  render_path
    adds one keyword-only parameter after them: `uniforms`, the draws
    handed in by ray and bounce."""
    extra = {"render_path": ["uniforms"]}
    for name in ("render_path", "render_direct", "render_ao"):
        want = list(inspect.signature(getattr(jpath, name)).parameters)
        params = inspect.signature(getattr(tpath, name)).parameters
        got = list(params)
        assert got == ([p if p != "key" else "generator" for p in want]
                       + extra.get(name, [])), name
        for p in extra.get(name, []):
            assert params[p].kind is inspect.Parameter.KEYWORD_ONLY
            assert params[p].default is None
