"""Shared helpers of the harness's tests: each cell at a size a CPU test
run holds (32-wide layers, few samples, small crops, K = 2)."""

import time

W32 = [None] + [32] * 8
HEAD32 = [None, 32, 32, 32, 3]
TINY = {
    "gan.train": {
        "config": {"set": {"arch.layers_feat": W32, "arch.layers_rgb": HEAD32,
                           "arch.layers_trans": [None, 32, 32, 32, 5],
                           "nerf.sample_intvs": 8, "batch_size": 2,
                           "data.image_size": [32, 32], "scan_steps": 2}},
        "workload": {"traffic": {"fixture": {"crop_res": 32,
                                             "n_train": 4}}}},
    "pretrain.train": {
        "config": {"set": {"arch.layers_feat": W32, "arch.layers_rgb": HEAD32,
                           "nerf.sample_intvs": 8, "nerf.rand_rays": 64,
                           "data.image_size": [32, 32], "scan_steps": 2}},
        "workload": {"traffic": {"fixture": {"crop_res": 32,
                                             "n_train": 4}}}},
    "pretrain.eval480": {
        "config": {"set": {"arch.layers_feat": W32, "arch.layers_rgb": HEAD32,
                           "nerf.sample_intvs": 8, "nerf.rand_rays": 64,
                           "data.image_size": [32, 32], "scan_steps": 2}},
        "workload": {"traffic": {
            "fixture": {"crop_res": 32, "n_train": 4, "n_test": 2},
            "frames": 4, "cfg": {"data.image_size": [48, 48]}}}},
}


def tiny_spec(cell):
    """The cell's spec with the small sizes merged in, its data generated
    in each run's own directory (parallel tests share no cache)."""
    from bench_port.lib import harness
    spec = harness.cell_spec(cell)
    spec["cache"] = None
    for key in ("config", "workload"):
        spec[key] = harness._merge(spec[key], TINY[cell][key])
    return spec


def run_cpu(cell, seed=20231018, trace=False):
    """One run of the cell on the CPU at the small size → (Run, checks,
    failed, result dict)."""
    import torch
    from bench_port.lib import harness
    t0 = time.time()
    spec = tiny_spec(cell)
    run, checks, failed = harness.execute(spec, seed, 0.05, trace,
                                          torch.device("cpu"), t0,
                                          log=lambda *a: None)
    out = harness.result_line(run, checks, failed, trace, 1, "cpu")
    return run, checks, failed, out

