"""Distribution: the reference's sharding rules over a torch device mesh
(`sharding`) and gradient compression (`compression`)."""
