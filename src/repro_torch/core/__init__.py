"""Core mechanisms of the paper, ported: DGC accumulation (§5.1), ALDP
(§5.2), asynchronous mixing (Eq. 6), Alg. 2 detection, the moments
accountant, the data-level attacks, and the round on a transformer
(`fed_step`)."""
from .accountant import MomentsAccountant                      # noqa: F401
from .aldp import (aldp_perturb, add_gaussian_noise,           # noqa: F401
                   clip_by_global_norm, epsilon_for_sigma, global_norm,
                   sigma_for_epsilon)
from .async_update import (communication_efficiency, mix,      # noqa: F401
                           mix_stale, staleness_alpha)
from .detection import (detect, detection_threshold, masked_mean,  # noqa: F401
                        ring_detect, ring_push, ring_threshold)
from .fed_step import FedStepConfig, fed_train_step, plain_train_step  # noqa: F401
