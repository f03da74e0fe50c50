"""The fused keyframe round's host-side indices and GraphAgg without host
waits, on the CPU:

- `models/update.segment_mean` (a scatter of ones for the counts, no
  mask) against its masked `bincount` form, bit for bit, for the ids
  `segment_ids` gives and for `DroidNet.forward`'s dump-row layout,
  gradients included;
- the round's one packed upload (`KeyframeStep._indices`): slots, ii,
  jj, the segment ids and frames `torch.unique` gives, and the BA's
  indices; uploaded again only when they change;
- a whole keyframe step against the same step whose update operator
  uploads its rows one by one, finds its segments with `torch.unique` and
  runs GraphAgg over the frames alone with the masked mean: bit for bit,
  with volumes correlated on the fly, cached, and with upsampling.

Seeded random DroidNet weights at the published widths, float32, 64×96.
"""

import dataclasses

import numpy as np
import pytest
import torch

from droid_slam_tpu_torch.config import SLAMConfig
from droid_slam_tpu_torch.geom import projective
from droid_slam_tpu_torch.lie import se3
from droid_slam_tpu_torch.models import update as update_mod
from droid_slam_tpu_torch.models.droidnet import DroidNet, random_init
from droid_slam_tpu_torch.ops import corr as corr_ops
from droid_slam_tpu_torch.ops import scatter
from droid_slam_tpu_torch.runtime import factor_graph, fused
from droid_slam_tpu_torch.runtime.state import DepthVideo

H, W = 64, 96
CPU = torch.device("cpu")
N_FRAMES = 6
# active edges over frames 0..5; frame 4 has none as a source
II = np.array([0, 1, 1, 2, 2, 3, 3, 5, 5, 1, 0, 3])
JJ = np.array([1, 0, 2, 1, 3, 2, 5, 3, 4, 3, 2, 4])


def _masked_bincount_mean(x, ix, nseg):
    """`segment_mean` as it was: ids >= nseg dropped by a boolean index,
    counts by `bincount`."""
    keep = ix < nseg
    idx = ix[keep]
    tot = torch.zeros((nseg,) + x.shape[1:], dtype=torch.float32)
    scatter.index_add_(tot, 0, idx, x[keep].float())
    cnt = torch.bincount(idx, minlength=nseg).clamp(min=1).float()
    return (tot / cnt.reshape((-1,) + (1,) * (x.ndim - 1))).to(x.dtype)


def _segments(layout):
    """(ids, nseg) of `segment_ids` over an edge list, or of
    `DroidNet.forward` over a batch of 2 with padded edges sent to the
    dump row N of each batch entry."""
    if layout == "unique":
        ix, frames = factor_graph.segment_ids(torch.as_tensor(II))
        return ix, len(frames)
    B, N = 2, N_FRAMES
    ii = torch.as_tensor(II)
    mask = torch.as_tensor(np.arange(len(II)) % 4 != 3)
    seg1 = torch.where(mask, ii, torch.full_like(ii, N))
    ids = (seg1.repeat(B) + torch.arange(B).repeat_interleave(len(II))
           * (N + 1))
    return ids, B * (N + 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["unique", "dump_row"])
def test_segment_mean_is_bit_equal_to_the_masked_bincount_form(layout,
                                                               dtype):
    ix, nseg = _segments(layout)
    g = torch.Generator().manual_seed(7)
    x = torch.randn((len(ix), 16, 3, 5), generator=g).to(dtype)
    x.requires_grad_(True)
    got = update_mod.segment_mean(x, ix, nseg)
    want = _masked_bincount_mean(x, ix, nseg)
    assert got.dtype == dtype and torch.equal(got, want)
    up = torch.randn(got.shape, generator=g).to(dtype)
    g_got, = torch.autograd.grad((got * up).sum(), x)
    g_want, = torch.autograd.grad((want * up).sum(), x)
    assert torch.equal(g_got, g_want)


def _step(cache, upsample):
    """A fused keyframe step over N_FRAMES keyframes with random features
    and poses, and the graph state of II, JJ with noisy targets: the same
    every call."""
    cfg = SLAMConfig(image_size=(H, W), buffer=10, warmup=5,
                     corr_cache_mb=512 if cache else 0, upsample=upsample,
                     compute_dtype="float32")
    net = random_init(DroidNet(), 17).eval()
    video = DepthVideo(cfg, CPU)
    st, h, w = video.state, video.fht, video.fwd
    rng = np.random.default_rng(5)

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape)).float()

    n = N_FRAMES
    st.fmaps[:n] = rand(n, 1, h, w, 128).to(st.fmaps.dtype)
    st.nets[:n] = torch.tanh(rand(n, h, w, 128)).to(st.nets.dtype)
    st.inps[:n] = torch.relu(rand(n, h, w, 128)).to(st.inps.dtype)
    xi = 0.05 * rand(n, 6)
    xi[0] = 0
    st.poses[:n] = se3.exp(xi)
    st.disps[:n] = torch.from_numpy(0.3 + 0.4 * rng.random((n, h, w))
                                    ).float()
    st.intrinsics[:n] = torch.tensor([0.9 * W, 0.9 * W, W / 2, H / 2]) / 8
    st.tstamp[:n] = torch.arange(float(n))
    video.counter = n
    step = fused.KeyframeStep(net, cfg, video)
    g = fused.init_graph_state(step.EA, step.EI, h, w, CPU)
    k = len(II)
    g.ii[:k], g.jj[:k], g.active[:k] = II, JJ, True
    g.age[:k] = np.arange(k) % 3
    g.seq[:k] = np.arange(k)
    g.tick = k
    tgt, _ = video.reproject(torch.from_numpy(II), torch.from_numpy(JJ))
    g.target[:k] = tgt + 0.5 * rand(*tgt.shape)
    g.weight[:k] = torch.from_numpy(rng.random(tgt.shape)).float()
    g.net[:k] = torch.tanh(rand(k, h, w, 128))
    return step, g


def test_packed_indices_are_the_rows_and_torch_unique_segments():
    step, g = _step(False, False)
    act = np.array([0, 2, 3, 5, 7, 8, 11])
    idx, nf = step._indices(g, act)
    EA, E = step.EA, len(act)
    ii_a = torch.as_tensor(g.ii[act])
    frames, ix = torch.unique(ii_a, return_inverse=True)
    assert nf == len(frames)
    views = [idx[r * EA:r * EA + E] for r in range(4)]
    for got, want in zip(views, (act, g.ii[act], g.jj[act], ix)):
        assert torch.equal(got, torch.as_tensor(want))
    assert torch.equal(idx[4 * EA:4 * EA + nf], frames)
    assert torch.equal(idx[5 * EA:], torch.from_numpy(step._ba_indices(g)))

    # uploaded once for each edge set
    last = step.upload.last
    assert step._indices(g, act)[0] is idx and step.upload.last is last
    step._indices(g, act[:-1])
    assert step.upload.last is not last


def _parent_update_op(self, g, act, vols=None):
    """The update operator as it was: three row uploads, segments from
    `torch.unique`, GraphAgg over the frames alone."""
    cfg, video = self.cfg, self.video
    st = video.state
    ht, wd = video.fht, video.fwd
    a = torch.as_tensor(act)
    ii_a, jj_a = torch.as_tensor(g.ii[act]), torch.as_tensor(g.jj[act])
    coords1, _ = projective.projective_transform(
        st.poses[None], st.disps[None], st.intrinsics[None], ii_a, jj_a)
    coords1 = coords1[0]
    coords0 = projective.coords_grid(ht, wd)
    motn = torch.clamp(torch.cat(
        [coords1 - coords0, g.target[a] - coords1], dim=-1), -64.0, 64.0)
    if vols is not None:
        corr = corr_ops.lookup_pyramid_flat(
            vols, coords1.reshape(len(act), ht * wd, 2)
        ).reshape(len(act), ht, wd, -1)
    else:
        corr = factor_graph.edge_correlation(
            st.fmaps, ii_a, jj_a, coords1,
            factor_graph.corr_pixel_chunk(cfg, self.EA, ht * wd))
    frames, ix = torch.unique(ii_a, return_inverse=True)
    out = self.net.update(g.net[a], st.inps[ii_a], corr, motn, ix=ix,
                          nseg=len(frames), with_upmask=cfg.upsample)
    net_new, delta, weight, eta = out[:4]
    g.net[a] = net_new.float()
    g.target[a] = coords1 + delta
    g.weight[a] = weight
    st.damping[frames] = eta
    return frames, (out[4] if cfg.upsample else None)


@pytest.mark.parametrize("cache,upsample", [(False, False), (True, False),
                                            (False, True)])
def test_keyframe_step_is_bit_equal_to_the_unique_segment_round(
        monkeypatch, cache, upsample):
    torch.set_num_threads(2)
    got_step, got_g = _step(cache, upsample)
    want_step, want_g = _step(cache, upsample)
    assert got_step.cache_vols == cache
    with torch.no_grad():
        got_g, got_cull = got_step(got_g, N_FRAMES)
        monkeypatch.setattr(fused.KeyframeStep, "update_op",
                            _parent_update_op)
        monkeypatch.setattr(update_mod, "segment_mean",
                            _masked_bincount_mean)
        want_g, want_cull = want_step(want_g, N_FRAMES)
    assert got_cull == want_cull
    got_st, want_st = got_step.video.state, want_step.video.state
    for f in dataclasses.fields(got_st):
        assert torch.equal(getattr(got_st, f.name),
                           getattr(want_st, f.name)), f.name
    for f in dataclasses.fields(got_g):
        a, b = getattr(got_g, f.name), getattr(want_g, f.name)
        same = torch.equal(a, b) if torch.is_tensor(a) else np.array_equal(
            a, b)
        assert same, f.name
