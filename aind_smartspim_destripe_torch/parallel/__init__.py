"""Multi-device routes: the mesh (a list of devices) and the row-sharded
("Y-halo") destripe step."""
