"""Wire schemas (copies of ``p2pfl_tpu/communication/proto``): the
documented envelope format (node.proto) and the reference-compatible
protobuf interop schema (interop.proto and its generated interop_pb2).
See communication/proto_wire.py for scope and the no-pickle divergence."""
