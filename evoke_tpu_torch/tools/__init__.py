from evoke_tpu_torch.tools.section_parser import section_text, normalize_section_name
from evoke_tpu_torch.tools.benchmark_builder import build_multiview_annotation
from evoke_tpu_torch.tools.factual_serialization import (heuristic_core_findings,
                                                   serialize_annotation)
