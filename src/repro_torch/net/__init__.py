"""Network layer of the port (`repro.net`): byte-accurate wire codecs,
the virtual-time link model and `NetSim`, the bridge the fleet engines
hold when a `NetworkSpec` names a codec.  With the spec at its analytic
default nothing here runs and the engines keep the analytic comm model."""
from .bridge import (NetSim, NetTrace, UploadDraw,  # noqa: F401
                     netsim_from_network)
from .codecs import (CODEC_NAMES, Codec, DenseF32, SparseBitpack,  # noqa: F401
                     SparseCoo, WireMessage, analytic_upload_bytes,
                     batched_encoded_bytes, count_nnz, get_codec,
                     index_bits)
from .link import (LinkProfile, draw_transfer,  # noqa: F401
                   draw_transfer_batch, materialize_bandwidth)
