from repro_torch.checkpoint.store import CheckpointStore  # noqa: F401
from repro_torch.checkpoint.async_writer import AsyncWriter  # noqa: F401
from repro_torch.checkpoint.pipeline import CheckpointPipeline  # noqa: F401
from repro_torch.checkpoint.lineage import (  # noqa: F401
    RunIdCollision, RunRegistry, generate_run_id, read_run_meta,
    write_run_meta)
