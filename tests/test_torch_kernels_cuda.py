"""The CUDA kernels against their plain PyTorch versions, on the card.

At the main path's shapes: K1 (Harris) bit-equal response and corners on a
rendered 48 x 480 x 640 stack; K2 (slab gather) within one bf16 ulp at
integer centers and 8e-3 at 163,840 fractional centers, in-bounds masks
equal; K2 at the centres one ported expansion round produces on the card,
plus NaN, +-inf and 1e10 centres, reading nothing outside the stack; K2s
(the sharded wrapper) on 4 virtual shards of cuda:0, bit-equal to one K2
call at 163,840 and 163,843 (the pad path) fractional centres; K1 and K2 on
cuda:1 while cuda:0 is current (skipped below two GPUs); and K3 (the
tile-resident sampler) in its three modes at S = 8, 32, 128 against its
plain versions and against K2, on the tool's case, an expansion round's
centres, non-finite centres and the edges of a guarded and of an
odd-width stack, the staging route each set took by device kernel name, a
640-wide view off a 16-byte boundary on the per-row route, and an S / wid
whose stages cannot fit a block refused before any launch.  K4 (the
grayscale conversion) bit-equal to the host conversion over all 2^24 RGB
triples, on the rendered stack and on shapes off the main path, one device
kernel a call, inputs refused before any launch, and ``device_gray``'s two
routes.  Also K1 on shapes off the main path (odd width, tiny images, a
4-byte-aligned stack, non-integer gray) and what K2's one-launch design
adds: its mask on the in-bounds limits, M = 1, 7 and 163,843, wid 0, 2
and 8, guarded and odd-width stacks, and one device kernel per call.
Marked ``cuda``; each test skips where ``torch.cuda.is_available()`` is
False.  On the card (tests/conftest.py imports jax, which the card's
machine lacks):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py -q
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

WID = 5                                      # 11x11 descriptors
MVS_SAMPLES = 32768 * 5                      # round_capacity x photo views
K2_FRAC_ATOL = 8e-3
SHARDS = 4                                   # virtual shards of one card
# NaN, +-inf and huge centres: out of bounds, and read nothing.
BAD_CENTRES = [[np.nan, 100], [100, np.nan], [np.nan, np.nan], [np.inf, 100],
               [-np.inf, 100], [100, np.inf], [100, -np.inf], [np.inf, -np.inf],
               [1e10, 100], [100, 1e10], [-1e10, -1e10], [3e9, -3e9], [-3e9, 3e9]]
# K3's device kernels by staging route (csrc/gather_tile.cu).
K3_KERNELS = {"tma": "gather_tile_tma_kernel",
              "rows": "gather_tile_rows_kernel"}


def render_ring(n=48, w=640, h=480):
    """The main path's shape: a 48-frame 640x480 textured-sphere ring."""
    from sfm_tpu_torch.utils import synth

    return synth.render_scene(synth.ring_rig(n), w=w, h=h, seed=0)


def bf16_ulps(got, want):
    """Largest |got - want| in units of the bf16 spacing at the larger value."""
    g, w = got.float(), want.float()
    mag = torch.maximum(g.abs(), w.abs())
    exp = torch.floor(torch.log2(torch.clamp_min(mag, 2.0 ** -126)))
    ulp = torch.exp2(exp - 7)
    return float(((g - w).abs() / ulp).max())


def device_kernel_names(fn, want=()):
    """Names of the device kernels one call of ``fn`` launches, under
    torch.profiler (``measure.profiled``).  With ``want``, kernel names
    one of which the call launches, a session that saw none of them lost
    its events and is taken again."""
    from sfm_tpu_torch.tools.measure import kernel_named, profiled

    def accept(_, kernels):
        return not want or any(kernel_named(e.name, base)
                               for e in kernels for base in want)

    _, kernels, _ = profiled(fn, accept, what="device kernel names")
    return {e.name for e in kernels}


def kernels_per_call(fn, calls=50):
    """The device kernels ``calls`` identical calls of ``fn`` launch, per
    call, and their names, under torch.profiler (``measure.profiled``):
    identical calls launch the same kernels, so a session whose count is
    not a whole number a call lost events and is taken again."""
    from sfm_tpu_torch.tools.measure import profiled

    for _ in range(3):
        fn()
    torch.cuda.synchronize()

    def body():
        for _ in range(calls):
            fn()

    _, kern, _ = profiled(
        body, lambda _, kernels: len(kernels) > 0 and len(kernels) % calls == 0,
        what=f"{calls} identical calls")
    return {"launches": len(kern) / calls,
            "kernels": sorted({e.name[:48] for e in kern})}


def check_k1(gray):
    """K1 against its plain version: bit-equal response and corners."""
    from sfm_tpu_torch.ops.harris import _harris_math, detect_corners, harris_response

    got = harris_response(gray, 0.04)
    want = _harris_math(gray, 0.04)
    torch.cuda.synchronize()
    assert torch.equal(got, want), "K1 response bit-equal to the plain version"
    kw = dict(max_corners=1024, nms_radius=4, rel_threshold=1e-6, border=WID + 1)
    ck, vk, _ = detect_corners(gray, kernels=True, **kw)
    cp, vp, _ = detect_corners(gray, kernels=False, **kw)
    assert torch.equal(ck, cp) and torch.equal(vk, vp), (
        "detect_corners through K1 bit-equal to the plain version")
    return {"max_abs_err": float((got - want).abs().max())}


def check_k1_shapes(dev):
    """K1 on shapes off the main path, bit-equal on integer gray: the CPU
    tests' 2 x 150 x 200; an odd width (4-byte loads and stores); images
    smaller than a thread's 4 columns and than the 3 x 3 support; a stack
    whose first element is only 4-byte aligned.  And on non-integer gray,
    where K1's separable box sums may differ from ``_box3``'s in their last
    bit (and det = sxx syy - sxy^2 amplifies that where it cancels): within
    1e-5 of the largest |R|."""
    from sfm_tpu_torch.ops.harris import _harris_math, harris_response

    g = torch.Generator(device="cpu").manual_seed(3)
    for shape in ((2, 150, 200), (3, 37, 201), (1, 5, 3), (1, 2, 2), (2, 33, 128)):
        gray = torch.randint(0, 256, shape, generator=g).float().to(dev)
        assert torch.equal(harris_response(gray, 0.04), _harris_math(gray, 0.04)), (
            f"K1 bit-equal on integer gray {shape}")
    n, h, w = 2, 64, 128
    buf = torch.randint(0, 256, (n * h * w + 1,), generator=g).float().to(dev)
    off = buf[1:].view(n, h, w)
    assert off.data_ptr() % 16 == 4, "the offset stack is 4-byte aligned"
    assert torch.equal(harris_response(off, 0.04), _harris_math(off, 0.04)), (
        "K1 bit-equal on a stack that is not 16-byte aligned")
    real = (torch.rand((3, 150, 200), generator=g) * 255).to(dev)
    got, want = harris_response(real, 0.04), _harris_math(real, 0.04)
    torch.cuda.synchronize()
    rel = float((got - want).abs().max() / want.abs().max())
    assert rel <= 1e-5, f"K1 on non-integer gray: {rel} of max |R| > 1e-5"
    return {"nonint_rel_err": rel}


def all_rgb_triples():
    """Every (r, g, b) uint8 triple once, as one (1, 4096, 4096, 3) stack."""
    v = np.arange(1 << 24, dtype=np.uint32)
    rgb = np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255], axis=-1)
    return rgb.astype(np.uint8).reshape(1, 4096, 4096, 3)


def host_gray(images):
    """The host route's values: ``np.rint(to_gray(x)).astype(np.uint8)`` as
    float32, what ``gray_tensor`` uploads and converts."""
    from sfm_tpu_torch.io.images import to_gray

    return np.rint(to_gray(images)).astype(np.uint8).astype(np.float32)


def check_k4(images):
    """K4 bit-equal to the host conversion over all 2^24 RGB triples and on
    the rendered stack ``images``, one launch a call.  Returns the uploaded
    uint8 RGB of ``images`` on the card."""
    from sfm_tpu_torch.ops.gray import rgb_to_gray

    for what, x in (("all 2^24 RGB triples", all_rgb_triples()),
                    (f"the rendered {images.shape} stack", images)):
        before = rgb_to_gray.launches
        got = rgb_to_gray(torch.from_numpy(x).cuda()).cpu().numpy()
        assert rgb_to_gray.launches == before + 1, "K4 counted one launch"
        want = host_gray(x)
        bad = int((got.view(np.uint32) != want.view(np.uint32)).sum())
        assert bad == 0, f"K4 on {what}: {bad} values differ from the host's"
    return torch.from_numpy(images).cuda()


def check_k4_shapes(dev):
    """K4 off the main path, bit-equal to the host conversion: N = 1, odd H,
    W = 1, 3 and 641, pixel counts that leave pixels after the last whole
    512-pixel chunk (and fewer than 512 in all), a stack whose first byte
    is not 16-byte aligned (the one-by-one route); and inputs refused before
    any launch: non-contiguous, not uint8, wrongly shaped."""
    from sfm_tpu_torch.ops.gray import rgb_to_gray

    rng = np.random.default_rng(4)
    shapes = ((1, 480, 640), (2, 37, 201), (3, 7, 5), (1, 5, 1), (2, 9, 3),
              (1, 33, 641), (1, 1, 1), (5, 1, 3))
    for n, h, w in shapes:
        x = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
        got = rgb_to_gray(torch.from_numpy(x).to(dev)).cpu().numpy()
        assert np.array_equal(got, host_gray(x)), f"K4 bit-equal at {(n, h, w)}"
    n, h, w = 2, 48, 64
    buf = torch.from_numpy(rng.integers(0, 256, n * h * w * 3 + 5,
                                        dtype=np.uint8)).to(dev)
    off = buf[5:].view(n, h, w, 3)
    assert off.data_ptr() % 16 == 5, "the offset stack is not 16-byte aligned"
    assert np.array_equal(rgb_to_gray(off).cpu().numpy(),
                          host_gray(off.cpu().numpy())), (
        "K4 bit-equal on a stack that is not 16-byte aligned")
    good = torch.zeros((2, 8, 8, 3), dtype=torch.uint8, device=dev)
    before = rgb_to_gray.launches
    for bad, err in ((good[:, :, ::2], ValueError),        # non-contiguous
                     (good.float(), TypeError),
                     (good[..., 0].contiguous(), TypeError),  # (N, H, W)
                     (torch.zeros((2, 8, 8, 4), dtype=torch.uint8, device=dev),
                      TypeError)):
        with pytest.raises(err):
            rgb_to_gray(bad)
    assert rgb_to_gray.launches == before, "a refused input launched K4"


def k2_inputs(gray, corners):
    """The two K2 shapes of the main path: integer centers at the feature
    shape, and MVS-round fractional centers (incl. near the clip edges)."""
    n, h, w = gray.shape
    k = corners.shape[1]
    img_i = (torch.arange(n, dtype=torch.int32, device=gray.device)[:, None]
             .expand(n, k).reshape(-1).contiguous())
    ctr_i = corners.reshape(-1, 2).float().contiguous()
    g = torch.Generator(device="cpu").manual_seed(0)
    m = MVS_SAMPLES
    img_f = torch.randint(0, n, (m,), generator=g, dtype=torch.int32)
    ctr_f = torch.rand((m, 2), generator=g) * torch.tensor([w + 6.0, h + 6.0]) - 3.0
    # A quarter of the samples sit within a pixel of the in-bounds edges.
    q = m // 4
    edge_x = torch.tensor([WID + 1.0, w - WID - 2.0])[torch.randint(0, 2, (q,), generator=g)]
    edge_y = torch.tensor([WID + 1.0, h - WID - 2.0])[torch.randint(0, 2, (q,), generator=g)]
    ctr_f[:q, 0] = edge_x + torch.rand(q, generator=g) * 2 - 1
    ctr_f[q:2 * q, 1] = edge_y[: q] + torch.rand(q, generator=g) * 2 - 1
    dev = gray.device
    return (img_i, ctr_i), (img_f.to(dev), ctr_f.to(dev).contiguous())


def fractional_inputs(stack):
    """``k2_inputs``'s fractional centres (they do not read the corners)."""
    return k2_inputs(stack, torch.zeros((stack.shape[0], 1, 2), dtype=torch.int32,
                                        device=stack.device))[1]


def check_k2(gray_bf16, k2_in):
    """K2 against its plain version at both shapes."""
    from sfm_tpu_torch.ops.gather import _sample_plain, sample_normalized_patches
    from sfm_tpu_torch.ops.ncc import bilinear_sample_patches_stack

    (img_i, ctr_i), (img_f, ctr_f) = k2_in
    out = {}
    for name, img, ctr in (("integer", img_i, ctr_i), ("fractional", img_f, ctr_f)):
        got, inb = sample_normalized_patches(gray_bf16, img, ctr, WID)
        want = _sample_plain(gray_bf16, img, ctr, WID)
        _, inb_plain = bilinear_sample_patches_stack(gray_bf16.float(), img, ctr, WID)
        torch.cuda.synchronize()
        assert torch.equal(inb, inb_plain), f"K2 {name}: in-bounds mask equal"
        err = float((got.float() - want.float()).abs().max())
        if name == "integer":
            ulps = bf16_ulps(got, want)
            assert ulps <= 1.0, f"K2 integer: {ulps} bf16 ulps > 1"
        else:
            assert err <= K2_FRAC_ATOL, f"K2 fractional: {err} > {K2_FRAC_ATOL}"
        assert bool(torch.isfinite(got.float()).all()), f"K2 {name}: finite"
        out[name] = err
    return out


def limit_centres(h, w, wid, dev):
    """Centres exactly on the four in-bounds limits and one f32 step
    either side of each, the other coordinate mid-image."""
    rows = []
    for lim, axis in ((wid + 1.0, 0), (w - wid - 2.0, 0),
                      (wid + 1.0, 1), (h - wid - 2.0, 1)):
        lim = torch.tensor(lim)
        for v in (lim, torch.nextafter(lim, torch.tensor(-1e30)),
                  torch.nextafter(lim, torch.tensor(1e30))):
            rows.append([float(v), h / 2] if axis == 0 else [w / 2, float(v)])
    return torch.tensor(rows, dtype=torch.float32, device=dev)


def check_k2_redesign(gray_bf16, img_f, ctr_f):
    """What K2's one-launch design adds to hold: the kernel's mask equal to
    the plain ``_inbounds`` on the limits and a float step either side;
    M = 1, 7 and 163,843 (a partial last block) bit-equal to the same rows
    of one larger call; wid 0, 2 and 8 on a small
    stack against the plain version; and the guarded and odd-width stacks of
    ``k3_cases`` for K2 itself (finite wherever the centre is: nothing read
    outside the stack)."""
    from sfm_tpu_torch.ops.gather import _sample_plain, sample_normalized_patches
    from sfm_tpu_torch.ops.ncc import _inbounds

    n, h, w = gray_bf16.shape
    dev = gray_bf16.device
    ctr = limit_centres(h, w, WID, dev)
    img = torch.arange(ctr.shape[0], dtype=torch.int32, device=dev) % n
    _, inb = sample_normalized_patches(gray_bf16, img, ctr, WID)
    want = _inbounds(ctr[:, 0], ctr[:, 1], h, w, WID)
    assert torch.equal(inb, want), "K2 mask on the limits equal to _inbounds"
    assert inb.view(4, 3).tolist() == [[True, False, True], [True, True, False]] * 2, (
        f"K2 mask on / inside / outside the limits: {inb.view(4, 3).tolist()}")

    g = torch.Generator(device="cpu").manual_seed(4)
    img_r = torch.cat([img_f, torch.randint(0, n, (3,), generator=g,
                                            dtype=torch.int32).to(dev)])
    ctr_r = torch.cat([ctr_f, (torch.rand((3, 2), generator=g)
                               * torch.tensor([w - 1.0, h - 1.0])).to(dev)])
    full, full_inb = sample_normalized_patches(gray_bf16, img_r, ctr_r, WID)
    plain = _sample_plain(gray_bf16, img_r, ctr_r, WID)
    err = float((full.float() - plain.float()).abs().max())
    assert err <= K2_FRAC_ATOL, f"K2 at M = {img_r.numel()}: {err}"
    assert torch.equal(full_inb, _inbounds(ctr_r[:, 0], ctr_r[:, 1], h, w, WID)), (
        f"K2 mask at M = {img_r.numel()}")
    for m in (1, 7):
        # the last m rows: another block, lane and store path than in `full`
        got, got_inb = sample_normalized_patches(
            gray_bf16, img_r[-m:].contiguous(), ctr_r[-m:].contiguous(), WID)
        assert torch.equal(got, full[-m:]) and torch.equal(got_inb, full_inb[-m:]), (
            f"K2 at M = {m} bit-equal to the same rows of a larger call")

    small = (torch.rand((3, 40, 64), generator=g) * 255).to(dev).to(torch.bfloat16)
    img_s = torch.randint(0, 3, (4099,), generator=g, dtype=torch.int32).to(dev)
    ctr_s = ((torch.rand((4099, 2), generator=g) * torch.tensor([70.0, 46.0]) - 3.0)
             .to(dev).contiguous())
    errs = {}
    for wid in (0, 2, 8):
        got, got_inb = sample_normalized_patches(small, img_s, ctr_s, wid)
        want = _sample_plain(small, img_s, ctr_s, wid)
        assert torch.equal(got_inb, _inbounds(ctr_s[:, 0], ctr_s[:, 1], 40, 64, wid)), (
            f"K2 wid {wid}: mask")
        if wid == 0:
            # a one-pixel patch is its own mean: 0 / max(0, 1e-8) = 0
            assert not bool(got.float().any()) and not bool(want.float().any()), (
                "K2 wid 0: zero descriptors")
        errs[wid] = float((got.float() - want.float()).abs().max())
        assert errs[wid] <= K2_FRAC_ATOL, f"K2 wid {wid}: {errs[wid]}"

    for name, gs, img, ctr in k3_cases(gray_bf16, img_f, ctr_f):
        if name not in ("guarded edges", "odd width"):
            continue
        fin = torch.isfinite(ctr).all(dim=1)
        got, got_inb = sample_normalized_patches(gs, img, ctr, WID)
        want = _sample_plain(gs, img, ctr, WID)
        assert bool(torch.isfinite(got.float()[fin]).all()), (
            f"K2 {name}: read outside the stack (NaN)")
        e = float((got.float() - want.float())[fin].abs().max())
        assert e <= K2_FRAC_ATOL, f"K2 {name}: {e} > {K2_FRAC_ATOL}"
        assert torch.equal(got_inb, _inbounds(ctr[:, 0], ctr[:, 1], gs.shape[1],
                                              gs.shape[2], WID)), f"K2 {name}: mask"
        errs[name] = e
    torch.cuda.synchronize()
    return {"max_abs_err": max(err, *errs.values())}


def k3_cases(gray_bf16, img_f, ctr_f):
    """The inputs K3 is held on, as (name, stack, img, ctr): the TPU tool's
    case (81,920 in-bounds centres on its random 48 x 480 x 640 stack); one
    expansion round's 163,840 fractional centres on the rendered ring; NaN,
    +-inf and huge centres plus samples on the first and last rows and
    columns of the first and last image, on a stack that lies between two
    NaN guard images (a read outside it turns the result NaN); and the same
    edges on an odd-width stack, whose rows are only 2-byte aligned."""
    from sfm_tpu_torch.tools import prof_tile

    dev = gray_bf16.device
    yield ("tool case", *prof_tile.case_tensors(81920, dev))
    yield ("expansion round", gray_bf16, img_f, ctr_f)
    g = torch.Generator(device="cpu").manual_seed(2)
    for name, (n, h, w) in (("guarded edges", tuple(gray_bf16.shape)),
                            ("odd width", (3, 40, 201))):
        buf = torch.full((n + 2, h, w), float("nan"), dtype=torch.bfloat16, device=dev)
        if name == "guarded edges":
            buf[1:-1] = gray_bf16
        else:
            buf[1:-1] = (torch.rand((n, h, w), generator=g) * 255).to(dev)
        k = 4096
        edge = torch.rand((k, 2), generator=g) * torch.tensor([w - 1.0, 14.0])
        edge[k // 2:, 1] += h - 15.0           # last rows; first rows above
        side = torch.rand((k, 2), generator=g) * torch.tensor([14.0, h - 1.0])
        side[k // 2:, 0] += w - 15.0           # last columns; first before
        ctr = torch.cat([edge, side, torch.tensor(BAD_CENTRES)])
        img = torch.cat([
            torch.tensor([0, n - 1, 0, n - 1],
                         dtype=torch.int32).repeat_interleave(k // 2),
            torch.arange(len(BAD_CENTRES), dtype=torch.int32) % n])
        yield name, buf[1:-1], img.to(dev), ctr.to(dev).contiguous()


def check_k3(gray_bf16, img_f, ctr_f):
    """K3 against its plain versions and against K2 on ``k3_cases``, at
    S in {8, 32, 128} in all three modes: copy-only bit-equal to the raw
    window; the full modes within K2_FRAC_ATOL of ``_sample_plain`` (one
    bf16 step at the descriptors' unit scale: only the order of the two
    sums differs) and finite wherever the centre is; reports whether the
    full modes are bit-equal to K2, whose arithmetic they share."""
    from sfm_tpu_torch.ops.gather import _sample_plain, sample_normalized_patches
    from sfm_tpu_torch.ops.gather_tile import (
        _copy_plain,
        sample_normalized_patches_tiled,
    )
    from sfm_tpu_torch.tools.prof_tile import modes

    out = {"max_abs_err": 0.0, "bit_equal_k2": True, "launches": 0}
    for name, g, img, ctr in k3_cases(gray_bf16, img_f, ctr_f):
        fin = torch.isfinite(ctr).all(dim=1)
        want = {True: _sample_plain(g, img, ctr, WID)[fin],
                False: _copy_plain(g, img, ctr, WID)[fin]}
        k2 = sample_normalized_patches(g, img, ctr, WID)[0][fin]
        for _, mode, S, kw in modes():
            before = sample_normalized_patches_tiled.launches
            got = sample_normalized_patches_tiled(g, img, ctr, WID, **kw)[fin]
            torch.cuda.synchronize()
            out["launches"] += sample_normalized_patches_tiled.launches - before
            assert bool(torch.isfinite(got.float()).all()), (
                f"K3 {name} S={S} {mode}: read outside the stack (NaN)")
            if not kw["extract"]:
                assert torch.equal(got, want[False]), (
                    f"K3 {name} S={S} copy-only: not bit-equal to the window")
                continue
            e = float((got.float() - want[True].float()).abs().max())
            assert e <= K2_FRAC_ATOL, f"K3 {name} S={S} {mode}: {e} > {K2_FRAC_ATOL}"
            out["max_abs_err"] = max(out["max_abs_err"], e)
            out["bit_equal_k2"] = out["bit_equal_k2"] and torch.equal(got, k2)
    assert out["launches"] == 4 * 9, "K3 launches counted once per call"
    return out


def check_k3_routes(gray_bf16, img_f, ctr_f):
    """The staging route K3 took on each input set of ``k3_cases``, by the
    name of the device kernel one call launches: the tensor-map kernel on
    the three 640-wide stacks, the per-row kernel on the odd-width one, as
    ``tile_route`` (the wrapper's statement of the rule) says.  Returns
    name -> route."""
    from sfm_tpu_torch.ops.gather_tile import (
        sample_normalized_patches_tiled,
        tile_route,
    )
    from sfm_tpu_torch.tools.measure import kernel_named

    routes = {}
    for name, g, img, ctr in k3_cases(gray_bf16, img_f, ctr_f):
        want = "rows" if name == "odd width" else "tma"
        assert tile_route(g) == want, f"K3 {name}: tile_route {tile_route(g)}"
        names = device_kernel_names(
            lambda: sample_normalized_patches_tiled(g, img, ctr, WID),
            want=K3_KERNELS.values())
        seen = {route for route, base in K3_KERNELS.items()
                if any(kernel_named(n, base) for n in names)}
        assert seen == {want}, (f"K3 {name}: device kernels {sorted(seen)}, "
                                f"want {K3_KERNELS[want]}")
        routes[name] = want
    return routes


def check_k2_mvs_round(gray, calib, recon):
    """K2 against its plain version at the centres that one ported
    expansion round (the MVS defaults, gated to 5 views) produces from the
    seeded frontier of ``recon`` on the card, plus NaN, +-inf and huge
    centres.  The stack sits between two NaN images: a window read outside
    it would turn a finite centre's descriptor into NaN."""
    from sfm_tpu_torch.config import MvsConfig, resolve_photo_views
    from sfm_tpu_torch.mvs.cells import make_occupancy
    from sfm_tpu_torch.mvs.expand import expansion_round
    from sfm_tpu_torch.mvs.photoconsistency import _gated_samples
    from sfm_tpu_torch.mvs.pipeline import _split_frontier
    from sfm_tpu_torch.mvs.seed import build_seed_candidates, seed_patches
    from sfm_tpu_torch.ops.gather import _sample_plain, sample_normalized_patches
    from sfm_tpu_torch.ops.ncc import _inbounds

    n, h, w = gray.shape
    dev = gray.device
    buf = torch.full((n + 2, h, w), float("nan"), dtype=torch.bfloat16, device=dev)
    buf[1:-1] = gray.to(torch.bfloat16)
    g = buf[1:-1]
    cfg = MvsConfig()
    views = resolve_photo_views(cfg.max_photo_views, n)
    K, R, t, C = (torch.as_tensor(np.asarray(a, np.float32), device=dev)
                  for a in (calib.K, calib.R, calib.t, calib.centers))
    tid, ref_obs, oth = build_seed_candidates(recon.track_offsets, recon.track_obs)
    ints = [torch.as_tensor(np.asarray(a, np.int32), device=dev)
            for a in (tid, ref_obs, oth)]
    occ = make_occupancy(n, h, w, cfg.cell_size, dev)
    seeds, occ, _ = seed_patches(g, K, R, t, C, *ints, recon.num_tracks, occ,
                                 cfg, cfg.visible_lower_bound)
    fr, _ = _split_frontier(seeds, cfg.round_capacity)
    acc, _, packed = expansion_round(
        g, K, R, t, C, occ, fr["c"], fr["n"], fr["vis"], fr["proj"],
        fr["valid"], cfg, cfg.visible_lower_bound, cfg.round_capacity, 1.0)
    _, vidx, pix, _, _ = _gated_samples(K, R, t, acc["c"], acc["ref"], h, w,
                                        WID, views)
    bad = torch.tensor(BAD_CENTRES, dtype=torch.float32, device=dev)
    img = torch.cat([vidx.reshape(-1).to(torch.int32),
                     torch.arange(bad.shape[0], dtype=torch.int32, device=dev) % n])
    ctr = torch.cat([pix.reshape(-1, 2), bad]).contiguous()
    got, inb = sample_normalized_patches(g, img, ctr, WID)
    want = _sample_plain(g, img, ctr, WID)
    inb_plain = _inbounds(ctr[:, 0], ctr[:, 1], h, w, WID)
    torch.cuda.synchronize()
    assert torch.equal(inb, inb_plain), "K2 MVS round: in-bounds mask equal"
    assert not bool(inb[-bad.shape[0]:].any()), (
        "K2: non-finite/huge centres out of bounds")
    fin = torch.isfinite(ctr).all(dim=1)
    assert bool(torch.isfinite(got.float()[fin]).all()), (
        "K2 read outside the stack (a NaN guard image reached a finite centre)")
    err = float((got.float() - want.float())[fin].abs().max())
    assert err <= K2_FRAC_ATOL, f"K2 MVS round: {err} > {K2_FRAC_ATOL}"
    return {"samples": int(img.numel()), "max_abs_err": err,
            "nonfinite_centres": int((~fin).sum()),
            "round_accepted": int(packed[-1, 6])}


def check_second_gpu(gray, k2_in):
    """K1 and K2 on cuda:1 while cuda:0 is current, against their plain
    versions there (each wrapper launches on its tensor's device)."""
    from sfm_tpu_torch.ops.gather import _sample_plain, sample_normalized_patches
    from sfm_tpu_torch.ops.harris import _harris_math, harris_response

    dev = torch.device("cuda", 1)
    g1 = gray.to(dev)
    (_, _), (img_f, ctr_f) = k2_in
    img, ctr = img_f.to(dev), ctr_f.to(dev)
    with torch.cuda.device(0):
        resp = harris_response(g1, 0.04)
        resp_plain = _harris_math(g1, 0.04)
        desc, _ = sample_normalized_patches(g1.to(torch.bfloat16), img, ctr, WID)
        plain = _sample_plain(g1.to(torch.bfloat16), img, ctr, WID)
        torch.cuda.synchronize(dev)
        assert torch.cuda.current_device() == 0, "current device moved"
    assert resp.device == dev and torch.equal(resp, resp_plain), (
        "K1 on cuda:1 bit-equal to the plain version")
    err = float((desc.float() - plain.float()).abs().max())
    assert desc.device == dev and err <= K2_FRAC_ATOL, f"K2 on cuda:1: {err}"
    return {"k2_max_abs_err": err}


def check_k2_sharded(gray_bf16, img_f, ctr_f):
    """K2s against one K2 call (bit-equal) and against the plain version,
    at the MVS round's 163,840 samples and at 163,843 (the pad path) on
    SHARDS virtual shards of cuda:0 and, with two or more GPUs, over all of
    them; one K2 launch per shard.  Returns the errors and the shards
    launched over."""
    from sfm_tpu_torch.ops.gather import (
        _sample_plain,
        sample_normalized_patches,
        sample_normalized_patches_sharded,
    )
    from sfm_tpu_torch.parallel import DataMesh, data_mesh

    n, h, w = gray_bf16.shape
    dev = gray_bf16.device
    g = torch.Generator(device="cpu").manual_seed(1)
    extra_img = torch.randint(0, n, (3,), generator=g, dtype=torch.int32)
    extra_ctr = torch.rand((3, 2), generator=g) * torch.tensor([w - 1.0, h - 1.0])
    ragged = (torch.cat([img_f, extra_img.to(dev)]),
              torch.cat([ctr_f, extra_ctr.to(dev)]).contiguous())
    meshes = [DataMesh([dev] * SHARDS)]
    if torch.cuda.device_count() >= 2:
        meshes.append(data_mesh())
    err = err_plain = 0.0
    shards = 0
    for mesh in meshes:
        reps = mesh.replicate(gray_bf16)
        for name, (img, ctr) in (("round", (img_f, ctr_f)), ("ragged", ragged)):
            want, inb_want = sample_normalized_patches(gray_bf16, img, ctr, WID)
            plain = _sample_plain(gray_bf16, img, ctr, WID)
            before = sample_normalized_patches_sharded.launches
            got, inb = sample_normalized_patches_sharded(reps, img, ctr, WID, mesh)
            launched = sample_normalized_patches_sharded.launches - before
            for d in dict.fromkeys(mesh.devices):
                torch.cuda.synchronize(d)
            assert launched == mesh.size, (
                f"K2s launched {launched} times on {mesh.size} shards")
            assert torch.equal(got, want) and torch.equal(inb, inb_want), (
                f"K2s ({name}, {mesh}) bit-equal to one K2 call")
            e = float((got.float() - want.float()).abs().max())
            ep = float((got.float() - plain.float()).abs().max())
            assert ep <= K2_FRAC_ATOL, f"K2s against the plain version: {ep}"
            err, err_plain = max(err, e), max(err_plain, ep)
            shards += mesh.size
    return {"max_abs_err": err, "max_abs_err_plain": err_plain, "shards": shards}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture(scope="module")
def scene(card):
    return render_ring()


@pytest.fixture(scope="module")
def ring(scene):
    return scene[0]


@pytest.fixture(scope="module")
def stack(ring):
    from sfm_tpu_torch.io.images import gray_tensor

    return gray_tensor(ring, "cuda")


def test_k4_bit_equal_on_every_triple_and_the_ring(ring):
    from sfm_tpu_torch.ops.gray import rgb_to_gray

    before = rgb_to_gray.launches
    rgb = check_k4(ring)
    assert rgb_to_gray.launches == before + 2
    assert rgb.dtype == torch.uint8 and rgb.shape == ring.shape


def test_k4_shapes_off_the_main_path_and_refusals(card):
    from sfm_tpu_torch.ops.gray import rgb_to_gray

    before = rgb_to_gray.launches
    check_k4_shapes(torch.device("cuda"))
    assert rgb_to_gray.launches == before + 9  # 8 shapes, the offset stack


def test_k4_call_is_one_device_kernel(card):
    from sfm_tpu_torch.ops.gray import rgb_to_gray

    x = torch.randint(0, 256, (4, 48, 64, 3), dtype=torch.uint8, device="cuda")
    where = kernels_per_call(lambda: rgb_to_gray(x))
    assert where["launches"] == 1.0
    assert any("gray_kernel" in k for k in where["kernels"])


def test_device_gray_routes_on_the_card(card):
    from sfm_tpu_torch.io.images import device_gray
    from sfm_tpu_torch.ops.gray import rgb_to_gray
    from sfm_tpu_torch.utils.metrics import Metrics

    images = np.random.default_rng(5).integers(0, 256, (3, 40, 56, 3), np.uint8)
    m = Metrics()
    before = rgb_to_gray.launches
    a = device_gray(images, "cuda", metrics=m)
    assert rgb_to_gray.launches == before + 1
    assert m.values["gray_route"] == "kernel"
    assert device_gray(images, "cuda", metrics=m) is a  # cached: no launch
    assert rgb_to_gray.launches == before + 1
    m = Metrics()
    b = device_gray(images.copy(), "cuda", kernels=False, metrics=m)
    assert rgb_to_gray.launches == before + 1
    assert m.values["gray_route"] == "host"
    assert torch.equal(a, b) and a.dtype == b.dtype == torch.float32
    np.testing.assert_array_equal(a.cpu().numpy(), host_gray(images))


def test_k1_bit_equal(stack):
    from sfm_tpu_torch.ops.harris import harris_response

    before = harris_response.launches
    out = check_k1(stack)
    assert out["max_abs_err"] == 0.0
    assert harris_response.launches > before


def test_k1_shapes_off_the_main_path(stack):
    from sfm_tpu_torch.ops.harris import harris_response

    before = harris_response.launches
    out = check_k1_shapes(stack.device)
    assert out["nonint_rel_err"] <= 1e-5
    assert harris_response.launches == before + 7


def test_k2_mask_partial_blocks_and_widths(stack):
    from sfm_tpu_torch.ops.gather import sample_normalized_patches

    img_f, ctr_f = fractional_inputs(stack)
    before = sample_normalized_patches.launches
    out = check_k2_redesign(stack.to(torch.bfloat16), img_f, ctr_f)
    assert out["max_abs_err"] <= K2_FRAC_ATOL
    # limits, M = 163,843, 1 and 7, three widths, two stacks
    assert sample_normalized_patches.launches == before + 9


def test_k2_call_is_one_device_kernel(stack):
    from sfm_tpu_torch.ops.gather import sample_normalized_patches

    g = stack.to(torch.bfloat16)
    img_f, ctr_f = fractional_inputs(stack)
    where = kernels_per_call(
        lambda: sample_normalized_patches(g, img_f, ctr_f, WID))
    assert where["launches"] == 1.0
    desc, inb = sample_normalized_patches(g, img_f, ctr_f, WID)
    assert inb.dtype == torch.bool and inb.shape == img_f.shape
    assert desc.shape == (img_f.shape[0], (2 * WID + 1) ** 2)


def test_k2_within_bounds(stack):
    from sfm_tpu_torch.ops.gather import sample_normalized_patches
    from sfm_tpu_torch.ops.harris import detect_corners

    corners, _, _ = detect_corners(stack, max_corners=1024, nms_radius=4,
                                   rel_threshold=1e-6, border=WID + 1)
    before = sample_normalized_patches.launches
    err = check_k2(stack.to(torch.bfloat16), k2_inputs(stack, corners))
    assert err["fractional"] <= K2_FRAC_ATOL
    assert sample_normalized_patches.launches == before + 2


def test_k2_at_expansion_round_and_nonfinite_centres(scene, stack):
    from sfm_tpu_torch.config import PipelineConfig, RuntimeConfig
    from sfm_tpu_torch.ops.gather import sample_normalized_patches
    from sfm_tpu_torch.sfm import structure_from_motion

    images, calib = scene
    recon = structure_from_motion(images, calib, PipelineConfig(
        runtime=RuntimeConfig(device="cuda", kernels=True)))
    before = sample_normalized_patches.launches
    out = check_k2_mvs_round(stack, calib, recon)
    assert out["max_abs_err"] <= K2_FRAC_ATOL
    assert out["samples"] > 100_000 and out["nonfinite_centres"] >= 8
    assert out["round_accepted"] > 0
    assert sample_normalized_patches.launches > before


def test_k2_sharded_bit_equal_to_one_call(stack):
    from sfm_tpu_torch.ops.gather import sample_normalized_patches_sharded

    img_f, ctr_f = fractional_inputs(stack)
    before = sample_normalized_patches_sharded.launches
    out = check_k2_sharded(stack.to(torch.bfloat16), img_f, ctr_f)
    assert out["max_abs_err"] == 0.0
    assert out["max_abs_err_plain"] <= K2_FRAC_ATOL
    # 2 shapes x 4 virtual shards (+ every GPU where there are several)
    assert out["shards"] >= 2 * SHARDS
    assert sample_normalized_patches_sharded.launches == before + out["shards"]


def test_k3_modes_against_plain_versions_and_k2(stack):
    from sfm_tpu_torch.ops.gather_tile import sample_normalized_patches_tiled

    img_f, ctr_f = fractional_inputs(stack)
    before = sample_normalized_patches_tiled.launches
    out = check_k3(stack.to(torch.bfloat16), img_f, ctr_f)
    assert out["max_abs_err"] <= K2_FRAC_ATOL
    assert out["bit_equal_k2"]
    assert sample_normalized_patches_tiled.launches == before + 36


def test_k3_routes_by_kernel_name(stack):
    img_f, ctr_f = fractional_inputs(stack)
    routes = check_k3_routes(stack.to(torch.bfloat16), img_f, ctr_f)
    assert routes == {"tool case": "tma", "expansion round": "tma",
                      "guarded edges": "tma", "odd width": "rows"}


def test_k3_refuses_what_cannot_fit(stack):
    from sfm_tpu_torch.ops.gather_tile import (
        MAX_SHARED_BYTES,
        sample_normalized_patches_tiled,
        shared_bytes,
    )

    g = stack.to(torch.bfloat16)
    img = torch.zeros(4, dtype=torch.int32, device=g.device)
    ctr = torch.full((4, 2), 50.0, device=g.device)
    assert shared_bytes(8, 256, True, "tma") > MAX_SHARED_BYTES
    before = sample_normalized_patches_tiled.launches
    torch.cuda.synchronize()
    with pytest.raises(ValueError, match="shared memory"):
        sample_normalized_patches_tiled(g, img, ctr, 8, samples_per_block=256,
                                        double_buffer=True)
    assert sample_normalized_patches_tiled.launches == before
    # S 192 single-buffered at wid 8 fits (224,512 bytes: above 48 KB, so
    # opted into) and launches
    assert shared_bytes(8, 192, False, "tma") == 224512
    out = sample_normalized_patches_tiled(g, img, ctr, 8, samples_per_block=192,
                                          double_buffer=False)
    torch.cuda.synchronize()
    assert sample_normalized_patches_tiled.launches == before + 1
    assert out.shape == (4, 17 * 17) and torch.isfinite(out.float()).all()


def test_k3_unaligned_base_takes_the_rows_route(stack):
    # A 640-wide view whose first element is 2 bytes past a 16-byte
    # boundary cannot be a tensor map's base: the rows kernel runs, with
    # the tensor-map kernel's results on an aligned copy of the same stack.
    from sfm_tpu_torch.ops.gather_tile import (
        sample_normalized_patches_tiled,
        tile_route,
    )
    from sfm_tpu_torch.tools.measure import kernel_named

    g = stack.to(torch.bfloat16)
    buf = torch.empty(g.numel() + 8, dtype=torch.bfloat16, device=g.device)
    view = buf[1:1 + g.numel()].view(g.shape)
    view.copy_(g)
    assert tile_route(g) == "tma" and tile_route(view) == "rows"
    n, h, w = g.shape
    gen = torch.Generator().manual_seed(5)
    ctr = (torch.rand((4096, 2), generator=gen)
           * torch.tensor([w - 1.0, h - 1.0])).to(g.device)
    img = torch.randint(0, n, (4096,), generator=gen,
                        dtype=torch.int32).to(g.device)
    for extract in (False, True):
        want = sample_normalized_patches_tiled(g, img, ctr, 5, extract=extract)
        names = device_kernel_names(lambda: sample_normalized_patches_tiled(
            view, img, ctr, 5, extract=extract), want=K3_KERNELS.values())
        assert any(kernel_named(k, "gather_tile_rows_kernel") for k in names)
        got = sample_normalized_patches_tiled(view, img, ctr, 5, extract=extract)
        assert torch.equal(got, want)


def test_k3_raises_instead_of_falling_back(stack):
    from sfm_tpu_torch.ops.gather_tile import sample_normalized_patches_tiled

    g = stack.to(torch.bfloat16)
    img = torch.zeros(4, dtype=torch.int32, device=g.device)
    ctr = torch.full((4, 2), 50.0, device=g.device)
    with pytest.raises(ValueError):  # a non-contiguous CUDA input
        sample_normalized_patches_tiled(g, img, ctr.t().contiguous().t())
    with pytest.raises(ValueError):  # inputs on two devices
        sample_normalized_patches_tiled(g, img.cpu(), ctr)


def test_kernels_launch_on_their_tensors_device(stack):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from sfm_tpu_torch.ops.harris import detect_corners

    corners, _, _ = detect_corners(stack, max_corners=1024, nms_radius=4,
                                   rel_threshold=1e-6, border=WID + 1)
    out = check_second_gpu(stack, k2_inputs(stack, corners))
    assert out["k2_max_abs_err"] <= K2_FRAC_ATOL
