"""Scale-out solvers over ``torch.distributed`` (port of
``orb_slam3_ros_tpu.parallel``): the (obs, pt) mesh, the sharded BA, PCG BA,
VI-BA and pose-graph solves (``dist_ba``), the multi-process runtime
(``multihost``), the problem generators of their tests and benchmarks
(``problems``) and a runner for one such solve per process
(``scale_out``)."""
