from .registry import (ARCH_IDS, get_config, get_smoke_config,   # noqa: F401
                        long_context_variant)
