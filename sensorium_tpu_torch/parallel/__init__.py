"""Data parallelism of the port over cards and hosts: the mesh record, batch
sharding and the collectives (``mesh``), and process-group bring-up
(``multihost``)."""
