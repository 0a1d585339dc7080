from sfm_tpu_torch.parallel.mesh import DataMesh, data_mesh, shard_batch  # noqa: F401
