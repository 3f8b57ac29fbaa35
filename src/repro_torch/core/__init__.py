"""The FAST pipeline in PyTorch: fingerprints, Min-Max LSH, alignment and
the batch detection driver."""
from repro_torch.core.align import AlignConfig, Events  # noqa: F401
from repro_torch.core.detect import (DetectConfig, detect_events,  # noqa: F401
                                    detect_step)
from repro_torch.core.fingerprint import FingerprintConfig  # noqa: F401
from repro_torch.core.lsh import LSHConfig, Pairs  # noqa: F401
from repro_torch.core.synth import (ScenarioConfig,  # noqa: F401
                                    SynthConfig, make_dataset,
                                    make_scenario_dataset)
