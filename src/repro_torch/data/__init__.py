from .pipeline import (PipelineConfig, StreamingPipeline, SyntheticCorpus,
                       STATS_APP)
