"""The port's viz/ (SPH splat and render, smoothing lengths, HEALPix,
plots) against the JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through both packages: the
JAX side on JAX_PLATFORMS=cpu, the port with ``arch='cpu'``.
Tolerances: the splat and the render, max |port - JAX| / max |JAX| <=
2e-6 (both float32; the port sums each particle's 81 weights and each
pixel's deposits in another order than XLA's loop over the offsets,
measured ~3e-7 at N = 4,096); smoothing lengths 1e-12 relative (the same
float64 distances); HEALPix and the numpy plots exact; the frame's mass
within chip_smoke.MASS_TOL of its float64 value (chip_smoke.frame_mass).
"""
import matplotlib

matplotlib.use("Agg")

import jax.numpy as jnp  # noqa: E402
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
import nbody_streams_tpu.viz.healpix as JH  # noqa: E402
import nbody_streams_tpu.viz.plots as JPL  # noqa: E402
import nbody_streams_tpu.viz.sph as J  # noqa: E402
import nbody_streams_tpu.viz.sph_kernels as JK  # noqa: E402
import nbody_streams_tpu_torch.viz.healpix as TH  # noqa: E402
import nbody_streams_tpu_torch.viz.plots as TPL  # noqa: E402
import nbody_streams_tpu_torch.viz.sph as T  # noqa: E402
import nbody_streams_tpu_torch.viz.sph_kernels as TK  # noqa: E402

torch.set_num_threads(2)

N = 4096
TOL = 2e-6


def _rel(got, want):
    got, want = np.asarray(got, float), np.asarray(want, float)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture(scope="module")
def cloud():
    rng = np.random.default_rng(21)
    pos = rng.normal(0.0, 1.0, (N, 3)) * np.array([1.0, 0.6, 0.3])
    mass = rng.uniform(0.5, 1.5, N)
    h = rng.uniform(0.01, 0.4, N)
    return pos, mass, h


@pytest.mark.parametrize("shape,extent", [
    ((64, 64), (-3.0, 2.0, -1.5, 2.5)),      # rectangular extent and pixels
    ((64, 48), (-2.5, 2.5, -2.0, 2.0)),      # rectangular grid
])
def test_splat_matches_jax(cloud, shape, extent, monkeypatch):
    pos, mass, h = cloud
    nx, ny = shape
    x0, x1, y0, y1 = extent
    dx, dy = (x1 - x0) / nx, (y1 - y0) / ny
    j = J._splat(*(jnp.asarray(a, jnp.float32) for a in
                   (pos[:, 0], pos[:, 1], mass, h, x0, y0, dx, dy)),
                 nx, ny, 9)
    f32 = dict(dtype=torch.float32)
    t = T._splat(*(torch.as_tensor(np.asarray(a), **f32) for a in
                   (pos[:, 0], pos[:, 1], mass, h, x0, y0, dx, dy)),
                 nx, ny, 9)
    assert t.shape == (nx, ny) and t.dtype == torch.float32
    assert _rel(t.numpy(), np.asarray(j)) <= TOL
    # chunks of the particles deposit the same grid
    monkeypatch.setattr(T, "SPLAT_CHUNK", 1000)
    t2 = T._splat(*(torch.as_tensor(np.asarray(a), **f32) for a in
                    (pos[:, 0], pos[:, 1], mass, h, x0, y0, dx, dy)),
                  nx, ny, 9)
    assert _rel(t2.numpy(), np.asarray(j)) <= TOL


@pytest.mark.parametrize("form", ["native", "native_auto", "compat_kwargs",
                                  "reference"])
def test_render_matches_jax(cloud, form):
    pos, mass, h = cloud
    if form == "native":
        kw = dict(extent=(-3.0, 2.0, -1.5, 2.5), npix=64, smoothing=h)
        args = (pos, mass)
    elif form == "native_auto":
        kw = dict(npix=64, axes=(0, 2))
        args = (pos, mass)
    elif form == "compat_kwargs":
        kw = dict(resolution=64, gridsize=6.0, k_neighbors=17)
        args = (pos, mass)
    else:
        kw = dict(h=h, resolution=64, gridsize=6.0)
        args = (pos[:, 0], pos[:, 1], mass)
    img_j, ext_j = J.render_surface_density(*args, **kw)
    img_t, ext_t = T.render_surface_density(*args, arch="cpu", **kw)
    assert tuple(ext_t) == tuple(ext_j)
    assert img_t.shape == img_j.shape == (64, 64)
    assert img_t.dtype == np.asarray(img_j).dtype
    assert _rel(img_t, img_j) <= TOL


def test_render_conserves_mass(cloud):
    pos, mass, h = cloud
    # a frame that holds every stencil: all of the mass lands
    lim = np.abs(pos[:, :2]).max() + 1.0
    img, ext = T.render_surface_density(
        pos, mass, extent=(-lim, lim, -lim, lim), npix=64, smoothing=h,
        arch="cpu")
    area = (2 * lim / 64) ** 2
    assert abs(img.sum() * area / mass.sum() - 1.0) < 1e-6
    # the auto frame cuts some: the image holds the frame's float64 mass
    img, ext = T.render_surface_density(pos, mass, npix=64, smoothing=h,
                                        arch="cpu")
    area = (ext[1] - ext[0]) * (ext[3] - ext[2]) / 64 ** 2
    want = chip_smoke.frame_mass(pos[:, :2], mass, h, ext, 64)
    assert want < mass.sum()
    assert abs(img.sum() * area - want) / want <= chip_smoke.MASS_TOL


def test_render_cpu_gpu_layout(cloud, monkeypatch):
    pos, mass, h = cloud
    ref = TK.render_cpu(pos[:, 0], pos[:, 1], mass, h, resolution=64,
                        gridsize=6.0)
    assert _rel(ref, JK.render_cpu(pos[:, 0], pos[:, 1], mass, h,
                                   resolution=64, gridsize=6.0)) <= TOL
    # the reference layout is [ix, iy]: the native image transposed
    img, _ = T.render_surface_density(pos, mass, extent=(-3, 3, -3, 3),
                                      npix=64, smoothing=h, arch="cpu")
    np.testing.assert_array_equal(ref, img.T)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TK.render_gpu(pos[:, 0], pos[:, 1], mass, h, resolution=64,
                      gridsize=6.0)


def test_render_errors(cloud, monkeypatch):
    pos, mass, h = cloud
    with pytest.raises(TypeError, match="unexpected kwargs"):
        T.render_surface_density(pos, mass, arch="cpu", bogus=1)
    with pytest.raises(ValueError, match="cannot auto-size"):
        T.render_surface_density(np.zeros((10, 3)), np.ones(10),
                                 arch="cpu")
    with pytest.raises(ValueError, match="empty extent"):
        T.render_surface_density(pos, mass, extent=(1, 1, 0, 1), arch="cpu")
    with pytest.raises(ValueError, match="arch"):
        T.render_surface_density(pos, mass, arch="tpu")
    with pytest.raises(TypeError, match="mass array"):
        T.render_surface_density(pos[:, 0], pos[:, 1], arch="cpu")
    with pytest.raises(ValueError, match="same length"):
        T.render_surface_density(pos[:, 0], pos[:10, 1], mass, arch="cpu")
    # 'auto' and 'gpu' are the card: without one they raise
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for arch in ("auto", "gpu"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.render_surface_density(pos, mass, smoothing=h, arch=arch)


@pytest.mark.parametrize("dim", [2, 3])
def test_smoothing_lengths_match_jax(cloud, dim):
    pos = cloud[0][:2000, :dim]
    want = J.get_smoothing_lengths(pos, 16, method="ckdtree")
    for method in ("auto", "native", "ckdtree"):
        got = T.get_smoothing_lengths(pos, 16, method=method)
        np.testing.assert_allclose(got, want, rtol=1e-12)
    # k_neighbors counts the particle itself
    np.testing.assert_allclose(
        T.get_smoothing_lengths(pos, k_neighbors=17, method="native"),
        J.get_smoothing_lengths(pos, k_neighbors=17, method="ckdtree"),
        rtol=1e-12)
    with pytest.raises(ValueError, match="unknown kNN method"):
        T.get_smoothing_lengths(pos, method="nope")


def test_smoothing_lengths_lone_particle_and_auto_switch(cloud, monkeypatch):
    for method in ("auto", "native", "ckdtree"):
        np.testing.assert_array_equal(
            T.get_smoothing_lengths(np.ones((1, 3)), method=method),
            J.get_smoothing_lengths(np.ones((1, 3)), method="ckdtree"))
    # 'auto' takes the native library from NATIVE_MIN_N particles up
    from nbody_streams_tpu_torch import native

    calls = []
    knn = native.knn_radius
    monkeypatch.setattr(native, "knn_radius",
                        lambda p, k: calls.append(len(p)) or knn(p, k))
    pos = cloud[0][:600]
    T.get_smoothing_lengths(pos, 8)
    assert calls == []
    monkeypatch.setattr(T, "NATIVE_MIN_N", 500)
    got = T.get_smoothing_lengths(pos, 8)
    assert calls == [600]
    np.testing.assert_allclose(
        got, J.get_smoothing_lengths(pos, 8, method="ckdtree"), rtol=1e-12)


@pytest.mark.parametrize("nside", [1, 2, 8, 64, 256])
def test_healpix_identical_to_jax(nside):
    pix = np.arange(TH.nside2npix(nside))
    th_t, ph_t = TH.pix2ang_ring(nside, pix)
    th_j, ph_j = JH.pix2ang_ring(nside, pix)
    np.testing.assert_array_equal(th_t, th_j)
    np.testing.assert_array_equal(ph_t, ph_j)
    np.testing.assert_array_equal(TH.ang2pix_ring(nside, th_t, ph_t), pix)
    rng = np.random.default_rng(nside)
    v = rng.normal(size=(5000, 3))
    w = rng.uniform(0.5, 2.0, 5000)
    np.testing.assert_array_equal(TH.vec2pix_ring(nside, v),
                                  JH.vec2pix_ring(nside, v))
    np.testing.assert_array_equal(TH.healpix_map(nside, v, weights=w),
                                  JH.healpix_map(nside, v, weights=w))


def test_healpix_edge_cases_match_jax():
    th = np.array([1e-12, 0.1, 1.0, np.pi / 2, 3.0, np.pi - 1e-12])
    for phi in (0.0, np.linspace(0, 2 * np.pi, th.size)):
        np.testing.assert_array_equal(TH.ang2pix_ring(8, th, phi),
                                      JH.ang2pix_ring(8, th, phi))
    np.testing.assert_array_equal(TH.ang2pix_ring(4, 0.1, th),
                                  JH.ang2pix_ring(4, 0.1, th))
    with pytest.raises(ValueError, match="zero-length"):
        TH.vec2pix_ring(16, np.array([[1.0, 0, 0], [0.0, 0.0, 0.0]]))


def _image(ax):
    return np.asarray(ax.images[0].get_array())


def test_plot_density_matches_jax(cloud):
    pos, mass, h = cloud
    for method, kw in (("histogram", {}), ("gauss_smooth",
                                            dict(smooth_sigma=2.0))):
        ax_t, img_t = TPL.plot_density(pos, mass, method=method, npix=48,
                                       extent=3.0, **kw)
        ax_j, img_j = JPL.plot_density(pos, mass, method=method, npix=48,
                                       extent=3.0, **kw)
        np.testing.assert_array_equal(img_t, img_j)
        np.testing.assert_array_equal(_image(ax_t), _image(ax_j))
    ax_t, img_t = TPL.plot_density(pos, mass, method="sph", npix=48,
                                   axes=(0, 2), arch="cpu", scale_bar=1.0)
    ax_j, img_j = JPL.plot_density(pos, mass, method="sph", npix=48,
                                   axes=(0, 2), arch="cpu", scale_bar=1.0)
    assert _rel(img_t, img_j) <= TOL
    assert ax_t.get_xlabel() == ax_j.get_xlabel() == "x [kpc]"
    plt.close("all")


def test_plot_mollweide_and_sky_match_jax(cloud):
    rng = np.random.default_rng(5)
    pos = rng.normal(size=(3000, 3)) * 20
    w = rng.uniform(0.5, 2.0, 3000)
    traj = np.column_stack([np.cos(np.linspace(0, 3, 20)),
                            np.sin(np.linspace(0, 3, 20)),
                            np.zeros(20)]) * 25
    for kw in (dict(), dict(weights=w, filter_radius=(5.0, 60.0),
                            normalize=True, add_traj=traj,
                            add_end_pt=True, initial_nside=16)):
        _, sky_t = TPL.plot_mollweide(pos, **kw)
        _, sky_j = JPL.plot_mollweide(pos, **kw)
        np.testing.assert_array_equal(sky_t, sky_j)
    stream = pos[:500] * 0.1 + np.array([10.0, 0, 0])
    xv = np.column_stack([stream, rng.normal(0, 5, (500, 3))])
    _, obs_t = TPL.plot_stream_sky(xv)
    _, obs_j = JPL.plot_stream_sky(xv)
    for key in obs_j:
        np.testing.assert_allclose(obs_t[key], obs_j[key], rtol=1e-12,
                                   atol=1e-12)
    plt.close("all")


def test_plot_stream_evolution_matches_jax(cloud):
    pos = cloud[0][:800]
    traj = np.stack([np.column_stack([pos * (1 + 0.2 * k),
                                      np.zeros_like(pos)])
                     for k in range(3)])
    times = np.array([0.0, 0.5, 1.0])
    fig_t, axs_t = TPL.plot_stream_evolution(traj, times, n_panels=3)
    fig_j, axs_j = JPL.plot_stream_evolution(traj, times, n_panels=3)
    assert len(axs_t) == len(axs_j) == 3
    for a, b in zip(axs_t, axs_j):
        np.testing.assert_array_equal(_image(a), _image(b))
        assert a.get_title() == b.get_title()
    with pytest.raises(ValueError, match="off-by-one"):
        TPL.plot_stream_evolution(traj, np.arange(5))
    plt.close("all")


def test_splat_conserves_mass_in_a_crowded_pixel():
    """Many particles in one pixel (200,000 within a tenth of a pixel,
    stencils inside the frame): the image holds their mass to 1e-6.  The
    float32 grid the JAX package accumulates in does not (each deposit
    loses its low bits against the pixel's running sum), which is why the
    port's grid is float64."""
    rng = np.random.default_rng(8)
    n = 200_000
    pos = rng.normal(0.0, 0.01, (n, 2))
    mass = rng.uniform(0.5, 1.5, n)
    h = np.full(n, 1e-3)
    extent, npix = (-1.0, 1.0, -1.0, 1.0), 16
    area = (2.0 / npix) ** 2
    img, _ = T.render_surface_density(
        np.c_[pos, np.zeros(n)], mass, extent=extent, npix=npix,
        smoothing=h, arch="cpu")
    assert abs(img.sum() * area / mass.sum() - 1.0) < 1e-6
    args = chip_smoke.splat_args(pos, mass, h, extent, npix, "cpu")
    f32 = T._splat(*args, acc_dtype=torch.float32).double().sum().item()
    assert abs(f32 / mass.sum() - 1.0) > 1e-6
