from repro_torch.data.synthetic import synthetic_batch, batch_for_step  # noqa: F401
from repro_torch.data.loader import PrefetchLoader  # noqa: F401
