from repro_torch.models.api import (Model, decode_input_specs, get_model,
                                    input_specs, prefill_input_specs,
                                    train_input_specs)
