"""Training-path building blocks of the PyTorch port against the JAX
package on the same numpy inputs: Sim(3), grad_clip, the PSD solve, convex
upsampling, differentiable BA, the losses, the learning-rate schedule, the
training graph and the plane scene."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from droid_slam_tpu.geom import ba as jba
from droid_slam_tpu.geom import chol as jchol
from droid_slam_tpu.geom import graph_utils as jgraph
from droid_slam_tpu.geom import losses as jlosses
from droid_slam_tpu.lie import se3 as jse3
from droid_slam_tpu.lie import sim3 as jsim3
from droid_slam_tpu.models import layers as jlayers
from droid_slam_tpu.models import update as jupdate
from droid_slam_tpu_torch.geom import ba as tba
from droid_slam_tpu_torch.geom import chol as tchol
from droid_slam_tpu_torch.geom import graph_utils as tgraph
from droid_slam_tpu_torch.geom import losses as tlosses
from droid_slam_tpu_torch.lie import se3 as tse3
from droid_slam_tpu_torch.lie import sim3 as tsim3
from droid_slam_tpu_torch.models import layers as tlayers
from droid_slam_tpu_torch.models import update as tupdate
from droid_slam_tpu_torch.training.train_step import onecycle_lr


def T(x):
    return torch.from_numpy(np.array(x))


def close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=tol)


# --------------------------------------------------------------- Sim(3)

def _sim3_elems(seed, n=16):
    rng = np.random.default_rng(seed)
    xi = rng.standard_normal((n, 7)).astype(np.float32) * 0.5
    # cover the small-angle and small-log-scale branches
    xi[0, 3:6] = 0.0
    xi[1, 6] = 0.0
    xi[2, 3:] = 0.0
    xi[3, 3:6] = 1e-6
    return xi


def test_sim3_matches_jax():
    """exp, log, mul, inv, act, scale_by on random and small-parameter
    twists: 2e-5 (f32 trigonometry and a 3×3 solve)."""
    xi, xj = _sim3_elems(0), _sim3_elems(1)
    g_t, h_t = tsim3.exp(T(xi)), tsim3.exp(T(xj))
    g_j, h_j = jsim3.exp(jnp.asarray(xi)), jsim3.exp(jnp.asarray(xj))
    close(g_t, g_j, 2e-5)
    close(tsim3.log(g_t), jsim3.log(g_j), 2e-5)
    close(tsim3.log(g_t), xi, 2e-4)            # round trip
    close(tsim3.mul(g_t, h_t), jsim3.mul(g_j, h_j), 2e-5)
    close(tsim3.inv(g_t), jsim3.inv(g_j), 2e-5)
    X = np.random.default_rng(2).standard_normal((16, 4)).astype(np.float32)
    close(tsim3.act(g_t, T(X)), jsim3.act(g_j, jnp.asarray(X)), 2e-5)
    close(tsim3.scale_by(g_t, 1.7), jsim3.scale_by(g_j, 1.7), 1e-6)
    close(tsim3.identity((3,)), jsim3.identity((3,)), 0)
    se = tse3.exp(T(xi[:, :6]))
    close(tsim3.from_se3(se), jsim3.from_se3(jse3.exp(jnp.asarray(
        xi[:, :6]))), 2e-6)


def test_sim3_log_gradient_matches_jax():
    """d/dξ of Σ log(exp(ξ) ∘ h)·c, through exp, mul and log: 1e-4."""
    xi, xj = _sim3_elems(3)[4:], _sim3_elems(4)[4:]
    c = np.random.default_rng(5).standard_normal(xi.shape).astype(np.float32)

    def fj(x):
        return jnp.sum(jsim3.log(jsim3.mul(jsim3.exp(x), jsim3.exp(
            jnp.asarray(xj)))) * c)

    x = T(xi).requires_grad_(True)
    (tsim3.log(tsim3.mul(tsim3.exp(x), tsim3.exp(T(xj)))) * T(c)).sum() \
        .backward()
    close(x.grad, jax.grad(fj)(jnp.asarray(xi)), 1e-4)


# ------------------------------------------------------------ grad_clip

def test_grad_clip_forward_and_backward_match_jax():
    """Identity forward; backward zeroes |g| > 0.01 and NaN, exactly as
    the JAX custom_vjp does."""
    x = np.linspace(-1, 1, 12).astype(np.float32)
    g = np.array([0.0, 0.009, -0.009, 0.01, -0.01, 0.011, -0.5, np.nan,
                  1e-4, np.inf, -np.inf, 0.0101], np.float32)
    xt = T(x).requires_grad_(True)
    y = tlayers.grad_clip(xt)
    np.testing.assert_array_equal(y.detach().numpy(), x)
    y.backward(T(g))
    _, vjp = jax.vjp(jlayers.grad_clip, jnp.asarray(x))
    want, = vjp(jnp.asarray(g))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want))
    assert xt.grad[7] == 0 and xt.grad[5] == 0 and xt.grad[1] == g[1]


# ------------------------------------------------------------ solve_psd

def _psd(seed, B=3, n=12):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, n, n)).astype(np.float32)
    H = A @ A.transpose(0, 2, 1) + 0.5 * np.eye(n, dtype=np.float32)
    b = rng.standard_normal((B, n, 2)).astype(np.float32)
    return H, b


def test_solve_psd_value_and_gradient_match_jax():
    """Value 1e-4; the custom backward (dL/db = H⁻¹ḡ, dL/dH = −x(H⁻¹ḡ)ᵀ)
    1e-3 relative to its scale (two triangular solves in f32)."""
    H, b = _psd(0)
    c = np.random.default_rng(1).standard_normal(b.shape).astype(np.float32)
    Ht, bt = T(H).requires_grad_(True), T(b).requires_grad_(True)
    x = tchol.solve_psd(Ht, bt)
    close(x, jchol.solve_psd(jnp.asarray(H), jnp.asarray(b)), 1e-4)
    (x * T(c)).sum().backward()
    gH, gb = jax.grad(lambda h, v: jnp.sum(jchol.solve_psd(h, v) * c),
                      argnums=(0, 1))(jnp.asarray(H), jnp.asarray(b))
    close(Ht.grad, gH, 1e-3 * float(np.abs(gH).max()))
    close(bt.grad, gb, 1e-3 * float(np.abs(gb).max()))


def test_solve_psd_failed_factorization_gives_zero_update():
    """A non-PD system in the batch: zero update and zero gradients for
    it (torch's cholesky would raise, JAX's returns NaN), the others
    solved as usual."""
    H, b = _psd(2)
    H[1] = -H[1]
    Ht, bt = T(H).requires_grad_(True), T(b).requires_grad_(True)
    x = tchol.solve_psd(Ht, bt)
    want = jchol.solve_psd(jnp.asarray(H), jnp.asarray(b))
    assert not x[1].any() and not np.asarray(want)[1].any()
    close(x, want, 1e-4)
    x.sum().backward()
    assert torch.isfinite(Ht.grad).all() and torch.isfinite(bt.grad).all()
    assert not Ht.grad[1].any() and not bt.grad[1].any()
    assert Ht.grad[0].any() and bt.grad[2].any()


def test_block_and_schur_solve_match_jax():
    """block_solve and schur_solve (ep + lm·diag damping): 1e-4."""
    rng = np.random.default_rng(3)
    B, P, M, D, HW = 2, 3, 4, 6, 10
    J = rng.standard_normal((B, P * D, 40)).astype(np.float32)
    H = (J @ J.transpose(0, 2, 1)).reshape(B, P, D, P, D).transpose(
        0, 1, 3, 2, 4).copy()
    E = 0.1 * rng.standard_normal((B, P, M, D, HW)).astype(np.float32)
    C = rng.uniform(1.0, 2.0, (B, M, HW)).astype(np.float32)
    v = rng.standard_normal((B, P, D)).astype(np.float32)
    w = rng.standard_normal((B, M, HW)).astype(np.float32)
    close(tchol.block_solve(T(H), T(v)),
          jchol.block_solve(jnp.asarray(H), jnp.asarray(v)), 1e-4)
    dx, dz = tchol.schur_solve(T(H), T(E), T(C), T(v), T(w))
    jdx, jdz = jchol.schur_solve(*(jnp.asarray(a) for a in (H, E, C, v, w)))
    close(dx, jdx, 1e-4)
    close(dz, jdz, 1e-4)
    close(tchol.schur_solve(T(H), T(E), T(C), T(v), T(w), sless=True), jdx,
          1e-4)


# --------------------------------------------------------- cvx_upsample

def test_cvx_upsample_matches_jax():
    """Convex 8× upsampling, multi-channel and the disparity wrapper:
    1e-5 (softmax and a 9-term sum)."""
    rng = np.random.default_rng(4)
    data = rng.standard_normal((2, 5, 7, 3)).astype(np.float32)
    mask = rng.standard_normal((2, 5, 7, 576)).astype(np.float32)
    close(tupdate.cvx_upsample(T(data), T(mask)),
          jupdate.cvx_upsample(jnp.asarray(data), jnp.asarray(mask)), 1e-5)
    close(tupdate.upsample_disp(T(data[..., 0]), T(mask)),
          jupdate.upsample_disp(jnp.asarray(data[..., 0]),
                                jnp.asarray(mask)), 1e-5)


# ------------------------------------------------------------------- BA

def _ba_problem(seed, B=1, P=4, h=6, w=8, pad=2):
    rng = np.random.default_rng(seed)
    xi = 0.05 * rng.standard_normal((B, P, 6)).astype(np.float32)
    poses = np.asarray(jse3.exp(jnp.asarray(xi)))
    disps = rng.uniform(0.3, 1.0, (B, P, h, w)).astype(np.float32)
    intr = np.tile(np.array([10.0, 10.0, w / 2, h / 2], np.float32),
                   (B, P, 1))
    ii, jj = jgraph.temporal_graph(P, r=1)
    ii = np.concatenate([ii, np.zeros(pad, np.int64)])
    jj = np.concatenate([jj, np.zeros(pad, np.int64)])
    E = len(ii)
    from droid_slam_tpu.geom import projective as jproj
    coords, _ = jproj.projective_transform(
        jnp.asarray(poses), jnp.asarray(disps), jnp.asarray(intr),
        jnp.asarray(ii), jnp.asarray(jj))
    target = np.asarray(coords) + 0.3 * rng.standard_normal(
        (B, E, h, w, 2)).astype(np.float32)
    weight = rng.uniform(0.2, 1.0, (B, E, h, w, 2)).astype(np.float32)
    weight[:, E - pad:] = 0.0
    eta = rng.uniform(0.001, 0.01, (B, P, h, w)).astype(np.float32)
    return target, weight, eta, poses, disps, intr, ii, jj


def test_ba_and_moba_match_jax():
    """One BA step (padded zero-weight edges, two fixed poses) and one
    motion-only step: poses 2e-5, disparities 1e-4 (f32 normal equations
    and a Cholesky solve, summed by index_add instead of segment_sum)."""
    target, weight, eta, poses, disps, intr, ii, jj = _ba_problem(0)
    args_t = [T(a) for a in (target, weight, eta, poses, disps, intr)]
    args_j = [jnp.asarray(a) for a in (target, weight, eta, poses, disps,
                                       intr)]
    p_t, d_t = tba.ba(*args_t, T(ii), T(jj), fixedp=2)
    p_j, d_j = jba.ba(*args_j, jnp.asarray(ii), jnp.asarray(jj), fixedp=2)
    close(p_t, p_j, 2e-5)
    close(d_t, d_j, 1e-4)
    # the anchored poses only pass through the quaternion renormalization
    np.testing.assert_allclose(p_t[:, :2].numpy(), poses[:, :2], atol=1e-6)
    m_t = tba.moba(args_t[0], args_t[1], *args_t[3:], T(ii), T(jj), fixedp=1)
    m_j = jba.moba(args_j[0], args_j[1], *args_j[3:], jnp.asarray(ii),
                   jnp.asarray(jj), fixedp=1)
    close(m_t, m_j, 2e-5)


def test_ba_gradients_match_jax():
    """Gradients of a scalar of the BA outputs with respect to target,
    weight and eta (through the linearization, the Schur complement and
    the custom solve backward): 2e-3 of each gradient's scale."""
    target, weight, eta, poses, disps, intr, ii, jj = _ba_problem(1)
    rng = np.random.default_rng(2)
    cp = rng.standard_normal(poses.shape).astype(np.float32)
    cd = rng.standard_normal(disps.shape).astype(np.float32)

    def fj(t, w, e):
        p, d = jba.ba(t, w, e, jnp.asarray(poses), jnp.asarray(disps),
                      jnp.asarray(intr), jnp.asarray(ii), jnp.asarray(jj),
                      fixedp=2)
        return jnp.sum(p * cp) + jnp.sum(d * cd)

    want = jax.grad(fj, argnums=(0, 1, 2))(
        jnp.asarray(target), jnp.asarray(weight), jnp.asarray(eta))
    leaves = [T(a).requires_grad_(True) for a in (target, weight, eta)]
    p, d = tba.ba(*leaves, T(poses), T(disps), T(intr), T(ii), T(jj),
                  fixedp=2)
    ((p * T(cp)).sum() + (d * T(cd)).sum()).backward()
    for leaf, g in zip(leaves, want):
        g = np.asarray(g)
        np.testing.assert_allclose(leaf.grad.numpy(), g,
                                   atol=2e-3 * np.abs(g).max())


# --------------------------------------------------------------- losses

def _pose_lists(seed, B=2, N=4, S=3):
    rng = np.random.default_rng(seed)
    Ps = np.asarray(jse3.exp(jnp.asarray(
        0.2 * rng.standard_normal((B, N, 6)).astype(np.float32))))
    Gs = np.stack([np.asarray(jse3.exp(jnp.asarray(
        0.2 * rng.standard_normal((B, N, 6)).astype(np.float32))))
        for _ in range(S)])
    return Ps, Gs


@pytest.mark.parametrize("do_scale", [False, True])
def test_geodesic_loss_matches_jax(do_scale):
    """Loss, metrics and the gradient with respect to the estimates, with
    padded edge slots masked: 1e-5 / 1e-4."""
    Ps, Gs = _pose_lists(0)
    ii = np.array([0, 1, 2, 0, 0, 0])
    jj = np.array([1, 2, 3, 2, 0, 0])
    emask = np.array([1, 1, 1, 1, 0, 0], bool)

    def fj(g):
        return jlosses.geodesic_loss(jnp.asarray(Ps), g, jnp.asarray(ii),
                                     jnp.asarray(jj), do_scale=do_scale,
                                     edge_mask=jnp.asarray(emask))

    (lj, mj), gj = jax.value_and_grad(fj, has_aux=True)(jnp.asarray(Gs))
    g = T(Gs).requires_grad_(True)
    lt, mt = tlosses.geodesic_loss(T(Ps), g, T(ii), T(jj),
                                   do_scale=do_scale, edge_mask=T(emask))
    close(lt, lj, 1e-5)
    for k in mj:
        close(mt[k], mj[k], 1e-4)
    lt.backward()
    close(g.grad, gj, 1e-4)


def test_residual_and_flow_loss_match_jax():
    """residual_loss (masked and not) 1e-6; flow_loss value, metrics and
    gradient with respect to the estimated disparities 1e-4."""
    rng = np.random.default_rng(1)
    res = rng.standard_normal((3, 2, 6, 4, 5, 2)).astype(np.float32)
    emask = np.array([1, 1, 1, 1, 0, 0], bool)
    for m_t, m_j in ((None, None), (T(emask), jnp.asarray(emask))):
        lt, _ = tlosses.residual_loss(T(res), edge_mask=m_t)
        lj, _ = jlosses.residual_loss(jnp.asarray(res), edge_mask=m_j)
        close(lt, lj, 1e-6)

    Ps, Gs = _pose_lists(2, B=1, N=3, S=2)
    h, w = 8, 12
    intr = np.tile(np.array([60.0, 60.0, 6.0, 4.0], np.float32), (1, 3, 1))
    d_gt = rng.uniform(0.3, 0.8, (1, 3, h, w)).astype(np.float32)
    d_est = rng.uniform(0.3, 0.8, (2, 1, 3, h, w)).astype(np.float32)

    def fj(d):
        return jlosses.flow_loss(jnp.asarray(Ps), jnp.asarray(d_gt),
                                 jnp.asarray(Gs), d, jnp.asarray(intr))

    (lj, mj), gj = jax.value_and_grad(fj, has_aux=True)(jnp.asarray(d_est))
    d = T(d_est).requires_grad_(True)
    lt, mt = tlosses.flow_loss(T(Ps), T(d_gt), T(Gs), d, T(intr))
    close(lt, lj, 1e-4)
    for k in mj:
        close(mt[k], mj[k], 1e-4)
    lt.backward()
    close(d.grad, gj, 1e-4 * max(1.0, float(np.abs(gj).max())))


def test_padded_identity_edges_give_finite_grads():
    """Padded edge slots (ii == jj == 0: identity relative pose, zero
    twist) must not leak NaN into the gradient (the safe `_norm`)."""
    B, N = 1, 4
    rng = np.random.default_rng(0)
    Ps = tse3.exp(T(0.1 * rng.standard_normal((B, N, 6)).astype(np.float32)))
    ii = T(np.array([0, 1, 2, 0, 0, 0, 0, 0]))
    jj = T(np.array([1, 2, 3, 2, 0, 0, 0, 0]))
    emask = T(np.array([1, 1, 1, 1, 0, 0, 0, 0], bool))
    dxi = torch.zeros((B, N, 6), requires_grad=True)
    # dxi = 0: estimates equal ground truth, every edge twist exactly 0
    loss, _ = tlosses.geodesic_loss(Ps, [tse3.mul(tse3.exp(dxi), Ps)], ii,
                                    jj, do_scale=False, edge_mask=emask)
    loss.backward()
    assert torch.isfinite(dxi.grad).all()


def test_flow_loss_nonfinite_coords_give_finite_grads():
    """Non-finite reprojections on masked pixels (negative and zero
    disparities) must not poison the flow loss's backward."""
    B, N, h, w = 1, 3, 8, 12
    rng = np.random.default_rng(1)
    Ps = tse3.exp(T(0.05 * rng.standard_normal((B, N, 6)).astype(
        np.float32)))
    intr = T(np.tile(np.array([60.0, 60.0, 48.0, 32.0], np.float32),
                     (B, N, 1)))
    d_gt = torch.full((B, N, h, w), 0.5)
    d = T(rng.uniform(-0.5, 0.5, (B, N, h, w)).astype(np.float32))
    d.requires_grad_(True)
    loss, _ = tlosses.flow_loss(Ps, d_gt, [Ps], [d], intr)
    loss.backward()
    assert torch.isfinite(loss) and torch.isfinite(d.grad).all()


# ------------------------------------------------------------- schedule

@pytest.mark.parametrize("steps,lr", [(100, 2e-5), (1000, 2.5e-4),
                                      (250000, 2.5e-4)])
def test_onecycle_lr_matches_optax(steps, lr):
    """`onecycle_lr` against optax.cosine_onecycle_schedule(steps, lr,
    pct_start=0.01) at the phase boundaries and in between: 2e-6
    relative plus 1e-7 of the peak (optax evaluates the cosine in f32,
    which near the end value cancels against the peak)."""
    sched = optax.cosine_onecycle_schedule(steps, lr, pct_start=0.01)
    up = int(0.01 * steps)
    probe = sorted({0, 1, up - 1, up, up + 1, up // 2, steps // 3,
                    steps // 2, steps - 1, steps, steps + 5} - {-1})
    for s in probe:
        np.testing.assert_allclose(onecycle_lr(s, steps, lr),
                                   float(sched(s)), rtol=2e-6, atol=1e-7 * lr,
                                   err_msg=f"step {s}")
    with pytest.raises(ValueError):
        onecycle_lr(0, 0, lr)
    # a zero-step warm-up starts at the peak
    assert onecycle_lr(0, 50, lr) == lr


# ---------------------------------------------------------------- graph

def test_training_graph_matches_jax():
    """The flow-distance matrix (1e-3 px) and the covisibility graph on a
    rendered scene; the temporal graph exactly."""
    from droid_slam_tpu.data import rgbd_utils as jrgbd
    from droid_slam_tpu_torch.data.synthetic import render_box_scene

    sc = render_box_scene(6, 64, 96, seed=2, motion_scale=0.1)
    disps = (1.0 / sc["depths"]).astype(np.float32)
    d8 = disps[:, 3::8, 3::8]
    intr8 = sc["intrinsics"] / 8.0
    dt = tgraph.compute_distance_matrix_flow(sc["poses_c2w"], d8, intr8)
    dj = jrgbd.compute_distance_matrix_flow(sc["poses_c2w"], d8, intr8)
    assert np.array_equal(np.isinf(dt), np.isinf(dj))
    fin = np.isfinite(dj)
    np.testing.assert_allclose(dt[fin], dj[fin], atol=1e-3, rtol=1e-4)
    gt = tgraph.build_frame_graph(sc["poses_c2w"][None], disps[None],
                                  sc["intrinsics"][None], num=24)
    gj = jgraph.build_frame_graph(sc["poses_c2w"][None], disps[None],
                                  sc["intrinsics"][None], num=24)
    # d[i, j] and d[j, i] tie up to rounding, so compare the edge sets
    assert sorted(zip(*gt)) == sorted(zip(*gj)) and len(gt[0]) == 24
    for a, b in zip(tgraph.temporal_graph(7, r=2),
                    jgraph.temporal_graph(7, r=2)):
        assert np.array_equal(a, b)


def test_plane_scene_matches_jax_renderer():
    """render_plane_scene without OpenCV: poses, depths and intrinsics as
    the JAX package's (1e-5); images differ only by the resampling's
    rounding (mean absolute difference under 1 grey level), fronto-
    parallel and slanted."""
    from droid_slam_tpu.data import synthetic as jsyn
    from droid_slam_tpu_torch.data import synthetic as tsyn

    for tilt in (0.0, 0.4):
        a = tsyn.render_plane_scene(4, 48, 64, seed=5, tilt=tilt)
        b = jsyn.render_plane_scene(4, 48, 64, seed=5, tilt=tilt)
        for k in ("poses_c2w", "depths", "intrinsics"):
            np.testing.assert_allclose(a[k], b[k], atol=1e-5, rtol=1e-5)
        assert a["images"].shape == b["images"].shape
        diff = np.abs(a["images"].astype(np.float32)
                      - b["images"].astype(np.float32))
        assert diff.mean() < 1.0, diff.mean()
