"""Every hand-written kernel's launch counter, by name.

Each kernel wrapper adds one to its counter where it launches its kernel
(`<wrapper>.launches`, and `mask_head_apply.bwd_launches` for the fused
head's backward). The serving path's kernels launch inside registered torch
ops (ops/registry.py), and their counters are incremented inside those ops,
so that the launches of an exported program (exp/export.py) are counted as
an eager call's. `kernel_counters()` names them all for the tools that
read them (tools/bench_torch.py, chip_smoke.py) and for the CUDA-graph
runner (train/cuda_graph.py), which adds a captured graph's launches to
them on every replay.
"""

from __future__ import annotations

from typing import Dict, Tuple


def kernel_counters() -> Dict[str, Tuple[object, str]]:
    """{name: (object, attribute)} of every hand-written kernel's launch
    counter."""
    from maavss_tpu_torch.ops import cuda_complex as cc
    from maavss_tpu_torch.ops import cuda_epilogue as ep
    from maavss_tpu_torch.ops.cuda_adam import adam_multi_tensor
    from maavss_tpu_torch.ops.cuda_lstm import (
        lstm_recurrence,
        lstm_recurrence_bwd,
    )
    from maavss_tpu_torch.ops.cuda_mask_head import mask_head_apply
    from maavss_tpu_torch.ops.cuda_pgenc import (
        pgenc_bwd,
        pgenc_bwd_apply,
        pgenc_bwd_sums,
        pgenc_layer,
        pgenc_train,
        pgenc_train_apply,
        pgenc_train_conv,
    )
    from maavss_tpu_torch.ops.stft import stft_features

    counters = {
        "lstm_fwd": lstm_recurrence, "lstm_bwd": lstm_recurrence_bwd,
        "pgenc_train": pgenc_train, "pgenc_bwd": pgenc_bwd,
        "pgenc_eval": pgenc_layer, "adam": adam_multi_tensor,
        "stft_feat": stft_features, "mask_head": mask_head_apply,
        "mask_mul": cc.mask_mul, "magphase": cc.magphase_fwd,
        "polar": cc.polar_spectrum_fwd, "epilogue_stats": ep.epilogue_stats,
        "epilogue_apply": ep.epilogue_apply,
        "epilogue_bwd_reduce": ep.epilogue_bwd_reduce,
        "epilogue_bwd_dy": ep.epilogue_bwd_dy,
        # the split routes under a data group (parallel/)
        "pgenc_train_conv": pgenc_train_conv,
        "pgenc_train_apply": pgenc_train_apply,
        "pgenc_bwd_sums": pgenc_bwd_sums, "pgenc_bwd_apply": pgenc_bwd_apply,
        "epilogue_stats_partials": ep.epilogue_stats_partials,
        "epilogue_stats_finish": ep.epilogue_stats_finish,
        "epilogue_bwd_partials": ep.epilogue_bwd_partials,
        "epilogue_bwd_finish": ep.epilogue_bwd_finish}
    out = {name: (fn, "launches") for name, fn in counters.items()}
    out["mask_head_bwd"] = (mask_head_apply, "bwd_launches")
    return out
