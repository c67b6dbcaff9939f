"""Data and tensor parallelism of the port over cards and hosts: the mesh
record, batch sharding and the collectives (``mesh``), the ``model`` axis's
weight slices and its two collectives (``tensor``), and process-group
bring-up (``multihost``)."""
