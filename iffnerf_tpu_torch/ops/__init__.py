from iffnerf_tpu_torch.ops.encoding import positional_encoding
from iffnerf_tpu_torch.ops.topk import exact_topk
