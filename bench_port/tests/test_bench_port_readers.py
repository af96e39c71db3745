"""Each metric reader on a small synthetic trace: a 10 ms window holding
two replays of a captured step (each a field kernel of 1 ms and a
discriminator convolution of 1 ms), and an eager step whose kernels ran
in the program's ranges."""

import os

import pytest

from bench_port.lib import flops, harness, trace

MS = 1_000_000
FIELD = "void (anonymous namespace)::field_fwd_kernel<0>(Params)"
CONV = "sm80_xmma_fprop_implicit_gemm_cudnn"


def window_events():
    ev = [(False, 0, trace.WINDOW, 0, 10 * MS, True)]
    for corr, t in ((101, 0), (102, 5 * MS)):
        ev.append((False, corr, "cudaGraphLaunch", t + 100, t + 200, False))
        ev.append((True, corr, FIELD, t + 1 * MS, t + 2 * MS, False))
        ev.append((True, corr, CONV, t + 2 * MS, t + 3 * MS, False))
    ev.append((False, 300, "cudaMemcpyAsync", 9 * MS, 9 * MS + 10, False))
    ev.append((True, 300, "Memcpy DtoH", 9 * MS, 9 * MS + MS // 2, False))
    return ev


def eager_events():
    return [(False, 0, "stage/render", 0, 100, True),
            (False, 1, "cudaLaunchKernel", 10, 20, False),
            (True, 1, FIELD, 30, 40, False),
            (False, 0, "step/disc_forward", 200, 300, True),
            (False, 2, "cudaLaunchKernel", 210, 220, False),
            (True, 2, CONV, 230, 240, False)]


def cfg_of(cell):
    from texpose_tpu_torch.utils.config import load_yaml
    spec = harness.cell_spec(cell)
    return load_yaml(os.path.join(harness.ROOT,
                                  spec["config"]["yaml"])).to_dict()


def run_of(view, cell="gan.train", shapes=None):
    shapes = shapes or {"kind": "gan_step", "B": 8, "p": 16, "N": 64}
    return harness.Run(setup_s=12.5, peak_bytes=3 * 2 ** 30, trace=view,
                       cfg=cfg_of(cell), shapes=shapes, spec=None,
                       window={"seconds": 2.0, "units": 200, "steps": 200,
                               "rays": 200 * 2048})


def read(name, run):
    return harness.reader(name).read(run)


def test_view_busy_idle_and_breakdown():
    view = trace.TraceView(window_events(), 2)
    assert view.window_s == pytest.approx(0.01)
    assert view.busy_s == pytest.approx(0.0045)
    run = run_of(view)
    assert read("device_idle.train", run) == pytest.approx(55.0)
    assert read("device_idle.eval", run) == pytest.approx(55.0)
    bd = view.breakdown()
    assert bd["device_ops"][0] == ["void field_fwd_kernel<0>",
                                   pytest.approx(0.002)]
    assert len(bd["idle_gaps"]) <= 10
    assert bd["idle_gaps"][0] == ["no traced host operation",
                                  pytest.approx(0.003)]


def test_end_to_end_readers():
    run = run_of(None)
    assert read("setup_s", run) == 12.5
    assert read("peak_mem_gib", run) == 3.0
    assert read("train_rays_per_s", run) == pytest.approx(204800.0)
    assert read("eval_views_per_s", run) is None
    run.window = {"seconds": 4.0, "units": 40, "frames": 40}
    assert read("eval_views_per_s", run) == pytest.approx(10.0)
    assert read("train_rays_per_s", run) is None


def test_mfu_and_roofline_train():
    view = trace.TraceView(window_events(), 2)
    run = run_of(view)
    m = flops.model_flops(run.cfg, run.shapes)
    assert read("mfu.train", run) == pytest.approx(
        100 * m * 2 / (0.01 * flops.PEAK_FLOPS))
    least = flops.least_seconds(*flops.field_work(run.cfg, run.shapes))
    # 1 ms of field kernels a step
    assert read("field_roofline.train", run) == pytest.approx(
        100 * least / 1e-3)
    assert read("disc_ms.train", run) is None      # no stages: nothing read


def test_disc_ms_from_the_aligned_stages():
    view = trace.TraceView(window_events(), 2,
                           trace.aligner(eager_events()))
    stages = [st for _, _, _, st in view.kernels]
    assert stages == ["render", "step/disc_forward", "render",
                      "step/disc_forward", None]
    assert read("disc_ms.train", run_of(view)) == pytest.approx(1.0)


def test_frame_readers():
    view = trace.TraceView(window_events(), 2)
    shapes = {"kind": "pretrain_frame", "H": 480, "W": 480, "N": 64}
    run = run_of(view, "pretrain.eval480", shapes)
    # busy 4.5 ms over 2 frames, less 1 ms of field kernels a frame
    assert read("render_glue_ms.eval", run) == pytest.approx(1.25)
    least = flops.least_seconds(*flops.field_work(run.cfg, shapes))
    assert read("field_roofline.eval", run) == pytest.approx(
        100 * least / 1e-3)
    assert read("mfu.eval", run) == pytest.approx(
        100 * flops.model_flops(run.cfg, shapes) * 2
        / (0.01 * flops.PEAK_FLOPS))


def test_no_trace_reads_nothing():
    run = run_of(None)
    for name in ("device_idle.train", "mfu.train", "field_roofline.train",
                 "disc_ms.train", "render_glue_ms.eval", "mfu.eval",
                 "field_roofline.eval", "device_idle.eval"):
        assert read(name, run) is None


def test_union_of_overlapping_intervals():
    assert trace.union_ns([(0, 10), (5, 15), (20, 30)]) == 25
    assert trace.merged([(5, 15), (0, 10), (20, 30)]) == [[0, 15], [20, 30]]
