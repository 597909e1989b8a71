"""Tiny sizes of each cell, for whole runs on the CPU."""


TINY_SCENE = {"width": 96, "height": 64, "object_side": 24, "object_radius_x": 16,
              "object_radius_y": 8}
TINY = {
    "fit-davis480-moving": (
        dict(TINY_SCENE, period=4),
        {"fit_video": {"resize": None, "num_points": 600, "iterations_first": 20,
                       "iterations_camera": 6, "iterations_after": 12, "densify_interval": 8,
                       "densify_interval_after": 5}}),
    "prep-davis480-seq16": (
        TINY_SCENE,
        {"gmflow": {"feature_channels": 32, "num_transformer_layers": 2, "num_reg_refine": 2,
                    "attn_splits_list": [2, 4]},
         "mast3r": {"enc_dim": 32, "enc_depth": 2, "enc_heads": 2, "dec_dim": 24,
                    "dec_depth": 2, "dec_heads": 2, "desc_dim": 6},
         "inference_size": 32, "sequence_frames": 4, "check_pairs": 2}),
}


def tiny_run(cell, seed=2 ** 31 + 11, seconds=1.0, trace=False, device="cpu"):
    import run as bench_run

    traffic, config = TINY[cell]
    rec = bench_run.run_cell(cell, seed, seconds, trace, device=device,
                             traffic_overrides=traffic, config_overrides=config)
    rec.pop("_info")
    return rec
