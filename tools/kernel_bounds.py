#!/usr/bin/env python3
"""The least time an H100 could take for each TPU kernel of the repo (every
function that reaches ``pl.pallas_call``), ported or not, at the shapes of
the port's main paths: 131,072 field rows = 2048 rays × 64 samples, full
width (configs/nerf_lm_adapt_gan.yaml for the texture field,
configs/nerf_lm_pretrain.yaml for the coarse field), and the hierarchical
pretrain's fine field, 393,216 rows = 2048 rays × (64 + 128) samples.

    python3 tools/kernel_bounds.py

The bound is chip_smoke.py's: the larger of the bytes the function must
move (each input read once, each output written once) over 3.35 TB/s and
its operations over 989 TFLOP/s (bf16 tensor cores) or 67 TFLOP/s (f32;
the render kernels of rows 6f/6b add their composite's f32 operations to
their bf16 ones).
A field function's input is its points (the last columns of its enc⊕pts
rows, or [M,3] for the trunk alone), not the posenc rows derived from them.
Rows 2, 6b and 7b also print the byte floor of their split design (the
dX-chain kernel, then the grouped dW GEMM, csrc/dw_gemm.cu): the bytes
phase (a) reads and writes (its inputs; the bf16 gradient planes, and for
rows 2 and 6b the recomputed hidden activations) plus those phase (b)
reads (the planes and the inputs it shares), over 3.35 TB/s — the least
time that design could take, beside the function's own bound.
Pure arithmetic on the shapes: no card is needed, and for the ported
kernels it reproduces the ``bound_ms`` of chip_smoke.py's kernels line.
"""

import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    sys.path.insert(0, HERE)
    import torch
    import chip_smoke as cs
    from texpose_tpu_torch.nn.fields import init_nerf, init_nerf_st
    from texpose_tpu_torch.utils.config import load_yaml, process_options

    def cfg(name):
        return process_options(load_yaml(os.path.join(HERE, "configs", name)))

    def t(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    BR, N, NF = 2048, 64, 192
    M, MF = BR * N, BR * NF
    st = init_nerf_st(cfg("nerf_lm_adapt_gan.yaml")).kernel_weights()
    co = init_nerf(cfg("nerf_lm_pretrain.yaml")).kernel_weights()
    st_params = [p for layer in st.trunk for p in (layer.w, layer.b)] \
        + st.head_params()
    trunk_params = [p for layer in co.trunk for p in (layer.w, layer.b)]
    e3_st, e3_co = 30, 3
    st_fwd = 2 * cs.weights_macs(st, e3_st) * M
    st_bwd = 2 * cs.st_bwd_macs(st, e3_st) * M
    co_macs = cs.coarse_macs(co, e3_co)
    trunk_ops = 2 * sum(layer.w.numel() for layer in co.trunk) * M
    enc_st = t(M, e3_st)
    lat = (t(8, 48), t(8, 16))
    head_grads = [t(*p.shape) for p in st.head_params()]
    co_grads = [t(*p.shape) for p in co.params()]

    def planes(n):                                     # dist, depth
        return t(BR, n), t(BR, n)

    def acts(m):
        return t(11, m, 256, dtype=torch.bfloat16)

    def floor(a_reads, a_writes, b_reads):
        """The split design's bytes: phase (a) reads and writes, (b) reads."""
        return cs.nbytes(*a_reads, *a_writes, *b_reads)

    def bf(*shape):
        return t(*shape, dtype=torch.bfloat16)

    nh = len(st.rgb) + len(st.trans) - 2              # row 2's hidden planes
    st_planes = (bf(nh, M, 256), bf(nh, M, 256), bf(M, 16))   # H, G, narrow
    st_floor = floor((bf(M, 256), bf(M, 32), t(M, 8)), st_planes,
                     (*st_planes, bf(M, 256), bf(M, 32)))
    # 6b's dX chain reads dens_raw, dist and the packed cotangent where
    # row 2's reads the raw outputs' gradients; it writes row 2's planes
    render_floor = floor((bf(M, 256), bf(M, 32), t(M, 1), t(BR, N),
                          t(BR, 16)), st_planes,
                         (*st_planes, bf(M, 256), bf(M, 32)))

    rows = [
        ("1 st_field fwd", cs.nbytes(enc_st, *lat, t(M, 9),
                                     *st_params), st_fwd, cs.PEAK_BF16),
        ("2 st_field bwd", cs.nbytes(t(M, 256, dtype=torch.bfloat16), enc_st,
                                     *lat, t(M, 8), *st.head_params(),
                                     *head_grads, *lat), st_bwd,
         cs.PEAK_BF16, 0, st_floor),
        ("3 composite_st fwd", cs.nbytes(t(M, 9), *planes(N), t(BR, 16)),
         cs.COMPOSITE_ST_FWD_OPS * M, cs.PEAK_F32),
        ("4 composite_st bwd", cs.nbytes(t(M, 9), t(BR, N), t(BR, 16),
                                         t(M, 8)),
         cs.COMPOSITE_ST_BWD_OPS * M, cs.PEAK_F32),
        ("6f st render fwd, eval", cs.nbytes(enc_st, t(1, 48), t(1, 16),
                                             *planes(N), t(BR, 16),
                                             *st_params), st_fwd,
         cs.PEAK_BF16, cs.COMPOSITE_ST_FWD_OPS * M),
        ("6f st render fwd, training", cs.nbytes(
            enc_st, *lat, *planes(N), t(BR, 16), t(M, 9),
            t(M, 256, dtype=torch.bfloat16), *st_params), st_fwd,
         cs.PEAK_BF16, cs.COMPOSITE_ST_FWD_OPS * M),
        ("6b st render bwd", cs.nbytes(t(M, 256, dtype=torch.bfloat16),
                                       enc_st, *lat, t(M, 1), t(BR, N),
                                       t(BR, 16), *st.head_params(),
                                       *head_grads, *lat),
         2 * cs.mega_bwd_macs(st, e3_st) * M, cs.PEAK_BF16,
         cs.COMPOSITE_ST_BWD_OPS * M, render_floor),
    ]
    for what, m in (("coarse", M), ("fine", MF)):
        e = t(m, e3_co)
        rows += [
            (f"7a {what} field fwd, eval", cs.nbytes(e, t(m, 4),
                                                     *co.params()),
             2 * co_macs[0] * m, cs.PEAK_BF16),
            (f"7a {what} field fwd, training", cs.nbytes(
                e, t(m, 4), acts(m), *co.params()),
             2 * co_macs[0] * m, cs.PEAK_BF16),
            (f"7b {what} field bwd", cs.nbytes(
                e, acts(m), t(m, 4),
                *co.params(), *co_grads), 2 * co_macs[1] * m, cs.PEAK_BF16,
             0, floor((acts(m), t(m, 4)), (acts(m), bf(m, 16)),
                      (acts(m), bf(m, 80), acts(m), bf(m, 16))))]
    rows += [
        ("8 coarse render fwd, eval", cs.nbytes(t(M, e3_co),
                                                *planes(N), t(BR, 8),
                                                *co.params()),
         2 * co_macs[0] * M, cs.PEAK_BF16),
        ("8 coarse render fwd, training", cs.nbytes(
            t(M, e3_co), *planes(N), t(BR, 8), t(M, 4), acts(M),
            *co.params()), 2 * co_macs[0] * M, cs.PEAK_BF16),
    ]
    for n in (N, NF):
        rows += [
            (f"9a composite_coarse fwd, N={n}", cs.nbytes(
                t(BR * n, 4), *planes(n), t(BR, 8)),
             cs.COMPOSITE_COARSE_FWD_OPS * BR * n, cs.PEAK_F32),
            (f"9b composite_coarse bwd, N={n}", cs.nbytes(
                t(BR * n, 4), *planes(n), t(BR, 8), t(BR * n, 4)),
             cs.COMPOSITE_COARSE_BWD_OPS * BR * n, cs.PEAK_F32)]
    rows.append(("10 trunk fwd", cs.nbytes(
        t(M, 3), t(M, 256, dtype=torch.bfloat16), t(M), *trunk_params),
        trunk_ops, cs.PEAK_BF16))
    print(f"{'row':32s} {'MB':>10s} {'GFLOP':>10s} {'bound ms':>10s}  by"
          f"{'split floor ms':>22s}")
    for name, n_bytes, ops, peak, *more in rows:
        ms, by = cs.bound(n_bytes, ops, peak, *more[:1])
        split = (f"{more[1] / cs.PEAK_BYTES * 1e3:12.4f} "
                 f"({more[1] / 1e9:.2f} GB)" if len(more) > 1 else "")
        print(f"{name:32s} {n_bytes / 1e6:10.2f} {ops / 1e9:10.2f} "
              f"{ms:10.4f}  {by:10s} {split}")
    print("(row 5 is rows 3/4 on the flat layout; row 9c is rows 9a/9b on "
          "it)")


if __name__ == "__main__":
    main()
