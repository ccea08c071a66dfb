"""Multi-device meshes: the ('dp', 'sp') mesh library (sharding) and the
mesh engines behind the Pipeline (engine)."""
