"""The port's gloo world of two on the data axis (mesh 2 x 1) against the
JAX package's sharded classes on a CPU mesh of that shape: the checks of
tests/test_torch_parallel.py, which runs the 1 x 2 world.  Image 0 of the
wrap batch overflows the DWT on rank 0 only, so rank 1 must raise
through the ranks' agreement on failures."""

from test_torch_parallel import check_world


def test_gloo_world_data_axis_matches_jax_sharded(tmp_path):
    check_world(2, tmp_path)
