"""The port's scripts: the host tools of the JAX package's ``tools/`` and
``extra/`` over the port's own modules (``colmap2nerf``,
``compute_scaling_factor``, ``histogram_correlation``, ``compute_metrics``,
``run_accuracy_gate``, ``auto_run_paramsets``, ``gen_fixture_scene``,
``convert_dinov2`` and the ``launch_all_*.sh`` scripts), and the ones that
measure the port's kernels on a CUDA card (``*_time``, ``k1_trace``,
``inerf_sweep``)."""
