"""The stage-1 modules of the port against the JAX package on the CPU:
point sampling, uncertainty sampling, the top-k mask selection, the point
losses, the Hungarian matcher and the seg VAE in every bottleneck and
encoder mode. Random draws are made on the JAX side from split keys and
handed to the port. Tolerances are stated at each comparison.
"""

import importlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ldmseg_tpu.models.seg_vae import SegVAE as JSegVAE  # noqa: E402
from ldmseg_torch.losses import matcher, point_losses as pl  # noqa: E402
from ldmseg_torch.models import convert  # noqa: E402
from ldmseg_torch.models.seg_vae import SegVAE  # noqa: E402
from ldmseg_torch.ops import grid_sample as gs  # noqa: E402
from ldmseg_torch.ops import uncertainty as unc  # noqa: E402

# the JAX packages' __init__ re-export functions under these module names
jmatcher = importlib.import_module("ldmseg_tpu.losses.matcher")
jpl = importlib.import_module("ldmseg_tpu.losses.point_losses")
jgs = importlib.import_module("ldmseg_tpu.ops.grid_sample")
junc = importlib.import_module("ldmseg_tpu.ops.uncertainty")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tiny tensors: the suite runs
    several workers at once, and torch's default pool of every core in
    each of them costs more than it gains here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _nchw(x):
    return _t(np.asarray(x, np.float32).transpose(0, 3, 1, 2))


def _nhwc(x):
    return x.detach().permute(0, 2, 3, 1).numpy()


def _close(out, ref, tol):
    """max |out - ref| <= tol * max(1, max|ref|)."""
    ref = np.asarray(ref, np.float32)
    bound = tol * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(np.asarray(out, np.float32) - ref).max())
    assert err <= bound, f"max abs diff {err} > {bound}"


def _coord_draws(key, n, num_points, ratio=3.0, importance=0.75):
    """The two uniform draws ``get_uncertain_point_coords`` makes from
    ``key`` (its own split)."""
    k_over, k_rand = jax.random.split(key)
    k_unc = int(importance * num_points)
    over = jax.random.uniform(k_over, (n, int(num_points * ratio), 2))
    extra = jax.random.uniform(k_rand, (n, num_points - k_unc, 2))
    return np.asarray(over), np.asarray(extra)


# ---------------------------------------------------------------------------
# point sampling (1e-6 in fp32)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_point_sample_matches_jax(mode):
    rng = np.random.RandomState(0)
    feat = rng.randn(2, 7, 9, 3).astype(np.float32)
    # in bounds, on the pixel edges and out of bounds (zero padding)
    coords = rng.uniform(-0.2, 1.2, (2, 50, 2)).astype(np.float32)
    coords[0, :4] = [[0.0, 0.0], [1.0, 1.0], [0.5 / 9, 0.5 / 7],
                     [1.5 / 9, 2.5 / 7]]
    ref = jgs.point_sample(jnp.asarray(feat), jnp.asarray(coords), mode=mode)
    ours = gs.point_sample(_t(feat), _t(coords), mode=mode)
    _close(ours.numpy(), ref, 1e-6)
    nchw = gs.point_sample(_nchw(feat), _t(coords), mode=mode,
                           channels_last=False)
    assert torch.equal(nchw, ours)
    grid = 2 * coords - 1
    _close(gs.grid_sample(_t(feat), _t(grid), mode=mode,
                          align_corners=True).numpy(),
           jgs.grid_sample(jnp.asarray(feat), jnp.asarray(grid), mode=mode,
                           align_corners=True), 1e-6)


# ---------------------------------------------------------------------------
# uncertainty sampling and the top-k selection (exact)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("which", ["top2", "sigmoid"])
def test_uncertain_point_coords_match_jax(which):
    rng = np.random.RandomState(1)
    c = 5 if which == "top2" else 1
    logits = rng.randn(3, 6, 8, c).astype(np.float32)
    jfn = junc.uncertainty_top2 if which == "top2" else \
        junc.uncertainty_sigmoid
    tfn = unc.uncertainty_top2 if which == "top2" else unc.uncertainty_sigmoid
    key = jax.random.key(11)
    ref = junc.get_uncertain_point_coords(key, jnp.asarray(logits), jfn, 20)
    draws = _coord_draws(key, 3, 20)
    ours = unc.get_uncertain_point_coords(_nchw(logits), tfn, 20,
                                          draws=draws)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    sampled = rng.randn(3, 11, c).astype(np.float32)
    np.testing.assert_array_equal(tfn(_t(sampled)).numpy(),
                                  np.asarray(jfn(jnp.asarray(sampled))))


def test_select_topk_masks_with_ties_matches_jax():
    # counts tie (3 classes of 4 pixels, zeros everywhere else), ids out of
    # range are dropped, the ignore label is never picked
    t = np.zeros((2, 4, 6), np.int32)
    t[0, 0, :4], t[0, 1, :4], t[0, 2, :4] = 5, 2, 7
    t[0, 3, :] = 9  # out of range for 8 classes
    t[1] = np.arange(24).reshape(4, 6) % 4
    for k in (3, 8):
        ids, valid = jpl.select_topk_masks(jnp.asarray(t), 8, 0, k)
        ours, ovalid = pl.select_topk_masks(_t(t), 8, 0, k)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ids))
        np.testing.assert_array_equal(ovalid.numpy(), np.asarray(valid))


def test_point_losses_match_jax():
    rng = np.random.RandomState(2)
    b, h, w, c = 2, 6, 10, 8
    logits = (2 * rng.randn(b, h, w, c)).astype(np.float32)
    targets = rng.randint(0, 6, (b, 12, 20)).astype(np.int32)
    corrupt = (rng.rand(b, 12, 20) > 0.3).astype(np.float32)
    cfg = dict(num_points=24, ignore_label=0, max_masks=5, temperature=0.7)
    key = jax.random.key(3)

    def jloss(lg):
        out = jpl.point_losses(key, lg, jnp.asarray(targets),
                               jpl.PointLossConfig(**cfg),
                               corrupt_mask=jnp.asarray(corrupt))
        return out["ce"] + out["mask"], out

    (_, ref), grad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jnp.asarray(logits))
    k_ce, k_mask = jax.random.split(key)
    draws = {"ce": _coord_draws(k_ce, b, 24),
             "mask": _coord_draws(k_mask, b * 5, 24)}
    x = _nchw(logits).requires_grad_(True)
    ours = pl.point_losses(x, _t(targets), pl.PointLossConfig(**cfg),
                           corrupt_mask=_t(corrupt), draws=draws)
    (ours["ce"] + ours["mask"]).backward()
    for k in ("ce", "mask"):
        np.testing.assert_allclose(float(ours[k]), float(ref[k]), rtol=1e-5)
    _close(_nhwc(x.grad), grad, 1e-5)


def test_hungarian_match_matches_jax():
    rng = np.random.RandomState(4)
    outputs = (3 * rng.randn(2, 6, 8, 5)).astype(np.float32)
    targets = rng.randint(0, 4, (2, 6, 8)).astype(np.int32)
    key = jax.random.key(9)
    ref, ref_ids = jax.jit(lambda o, t: jmatcher.hungarian_match(
        key, o, t, num_points=40, max_targets=3))(
            jnp.asarray(outputs), jnp.asarray(targets))
    coords = np.asarray(jax.random.uniform(key, (2, 40, 2)))
    ours, ids = matcher.hungarian_match(
        _nchw(outputs), _t(targets), num_points=40, max_targets=3,
        coords=coords)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_ids))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# the seg VAE in every parametrization and encoder mode (1e-4 of max|ref|)
# ---------------------------------------------------------------------------
TINY = dict(in_channels=4, int_channels=16, out_channels=8,
            block_out_channels=(8, 16), latent_channels=4,
            norm_num_groups=4, num_upscalers=1, upscale_channels=16,
            num_embeddings=16)
VARIANTS = {
    "gaussian": {},
    "gaussian_tanh_clamp": dict(act_fn="tanh", clamp_output=True),
    "auto_l2": dict(parametrization="auto", act_fn="l2"),
    "auto_clip": dict(parametrization="auto", act_fn="clip"),
    "gumbel": dict(parametrization="discrete_gumbel_softmax"),
    "codebook_frozen": dict(parametrization="discrete_codebook",
                            freeze_codebook=True, clamp_output=True),
    "mid_blocks": dict(num_mid_blocks=1, act_fn="sigmoid"),
    "resize_input": dict(resize_input=True, num_mid_blocks=2),
    "skip_encoder": dict(skip_encoder=True),
    "fuse_rgb": dict(fuse_rgb=True),
    "image_encoder": dict(image_encoder=True),
}


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_seg_vae_variant_matches_jax(name):
    kw = dict(TINY, **VARIANTS[name])
    rng = np.random.RandomState(5)
    cin = kw["in_channels"] + (3 if kw.get("fuse_rgb") else 0)
    size = 8 if kw.get("image_encoder") else 24
    x = rng.randn(2, size, size, cin).astype(np.float32)
    model = JSegVAE(**kw)
    variables = jax.jit(lambda k: model.init(
        {"params": k, "sample": k}, x[:1], sample_posterior=False))(
            jax.random.key(6))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    params = {"params": variables["params"]}
    # every leaf moved off its init value, the norms too
    params = jax.tree_util.tree_map(
        lambda v: (v + 0.05 * rng.randn(*v.shape)).astype(np.float32), params)
    if "constants" in variables:
        params["constants"] = variables["constants"]

    key = jax.random.key(7)

    @jax.jit
    def run(p, x):
        post = model.apply(p, x, method=JSegVAE.encode)
        z = post.sample(key)
        dec = model.apply(p, z, True, method=JSegVAE.decode)
        return post.mode(), z, post.kl(), dec

    mode, z, kl, dec = run(params, jnp.asarray(x))
    port = SegVAE(**kw)
    port.load_state_dict(convert.seg_vae_state_dict_from_jax(params, kw),
                         strict=True)
    p = kw.get("parametrization", "gaussian")
    noise = None
    if p == "gaussian":
        noise = _nchw(jax.random.normal(key, mode.shape))
    elif p == "discrete_gumbel_softmax":
        logits_shape = mode.shape[:3] + (kw["num_embeddings"],)
        noise = _nchw(jax.random.gumbel(key, logits_shape))
    with torch.no_grad():
        post = port.encode(_nchw(x))
        zs = post.sample(noise=noise)
        out = port.decode(zs, True)
    _close(_nhwc(post.mode()), mode, 1e-4)
    _close(_nhwc(zs), z, 1e-4)
    _close(post.kl().numpy(), kl, 1e-4)
    _close(_nhwc(out), dec, 1e-4)


def test_seg_vae_forward_masks_and_fuses_like_jax():
    kw = dict(TINY, fuse_rgb=True)
    rng = np.random.RandomState(8)
    bits = rng.randn(2, 24, 24, 4).astype(np.float32)
    rgb = rng.randn(2, 24, 24, 3).astype(np.float32)
    valid = (rng.rand(2, 12, 12) > 0.4).astype(np.float32)
    model = JSegVAE(**kw)
    params = jax.tree_util.tree_map(np.asarray, model.init(
        {"params": jax.random.key(1), "sample": jax.random.key(1)},
        bits[:1], rgb_sample=rgb[:1], sample_posterior=False))
    key = jax.random.key(2)
    def run(p, b, r, v):
        dec, post = model.apply(p, b, rgb_sample=r, valid_mask=v, rng=key)
        return dec, post.mean

    dec, mean = jax.jit(run)(params, jnp.asarray(bits), jnp.asarray(rgb),
                             jnp.asarray(valid))
    port = SegVAE(**kw)
    port.load_state_dict(convert.seg_vae_state_dict_from_jax(params, kw))
    noise = _nchw(jax.random.normal(key, mean.shape))
    with torch.no_grad():
        ours, opost = port(_nchw(bits), rgb_sample=_nchw(rgb),
                           valid_mask=_t(valid), noise=noise)
    _close(_nhwc(ours), dec, 1e-4)
    _close(_nhwc(opost.mean), mean, 1e-4)
