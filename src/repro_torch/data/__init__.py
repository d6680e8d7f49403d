from repro_torch.data.pipeline import MemmapLM, Prefetcher, SyntheticLM

__all__ = ["SyntheticLM", "MemmapLM", "Prefetcher"]
