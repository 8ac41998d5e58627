from repro_torch.data.synthetic import DataConfig, DataPipeline
