"""Host I/O boundary of the port: the streaming ingest loop, TRX backends and UDP PDU ingress."""
