"""A frame whose loop-closure gate fires, without the frames between, for
the loop-closure cell's CPU tests (`tests/test_torch_lc_reference.py`,
`slam_bench/tests/test_bench_lc_fault.py`) and the recorder's card test
(`tests/test_torch_tracing_cuda.py`). Imports no JAX.

The revisit clip (`synthetic.revisit_trajectory`) at 320x240: its frames
0, 2 and 4 run at stamps 0, 6 and 12, then its frame 27 (the pose of
frame 5) at stamp 20 with the last looked-up keyframe cleared, so that
the gate (`min_frame_gap` 8) fires against keyframe 0; keyframe 0's pose
is moved 3 cm, as drift would leave it, so that the accepted closure
deforms the map's later surfels."""

LC_LEAD = ((0, 0), (2, 6), (4, 12))
LC_GATE_FRAME = 27
LC_STAMP = 20
LC_DRIFT = (0.03, 0.0, 0.0)


def lc_config(C):
    """The loop-closure test configuration of the port's tests, from the
    config module C: 320x240, a 4096-surfel model, a 16-keyframe store,
    `min_frame_gap` 8."""
    return C.PipelineConfig(
        cam=C.CameraIntrinsics(fx=262.5, fy=262.5, cx=159.5, cy=119.5,
                               width=320, height=240),
        tps=C.TPSConfig(nb_iters=2, filter_iter=1),
        icp=C.ICPConfig(min_inliers=20.0),
        fusion=C.FusionConfig(nb_supersurfels_max=4096, visible_cap=2048),
        vo=C.VOConfig(nb_features=512, nb_levels=2, local_map_capacity=1024,
                      detect_cell=16),
        max_frames=40, enable_loop_closure=True,
        ferns=C.FernsConfig(enabled=True, min_frame_gap=8, max_keyframes=16))


def lc_gate_frame(cfg, device="cpu"):
    """(the port's state before the gate frame, its rgb, its depth) for
    the port's configuration `cfg` (`lc_config`) on `device`."""
    import torch

    from supersurfel_fusion_tpu_torch import pipeline, synthetic

    traj = synthetic.revisit_trajectory()
    i32 = dict(dtype=torch.int32, device=device)
    state = pipeline.init_state(cfg, device)
    for k, stamp in LC_LEAD:
        state, _ = pipeline.process_frame(
            state._replace(stamp=torch.tensor(stamp, **i32)),
            *synthetic.render(cfg.cam, *traj[k]), cfg)
    db = state.kf_store.db
    db = db._replace(poses_t=db.poses_t + torch.tensor(LC_DRIFT,
                                                       device=device))
    pre = state._replace(stamp=torch.tensor(LC_STAMP, **i32),
                         prev_fern_id=torch.tensor(-1, **i32),
                         kf_store=state.kf_store._replace(db=db))
    return (pre, *synthetic.render(cfg.cam, *traj[LC_GATE_FRAME]))
