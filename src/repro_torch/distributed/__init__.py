"""Multi-device code of the port: logical-axis sharding on a DeviceMesh
(DTensor), ZeRO-1 optimizer-state partitioning, and the int8
error-feedback all-reduce."""
