from repro_torch.data.pipeline import DataConfig, Prefetcher, batch_to, make_batch  # noqa: F401
