from sfm_tpu_torch.mvs.pipeline import dense_reconstruction, DenseReconstruction  # noqa: F401
