"""Multi-device parallelism: image-tile and spp sharding over a device mesh."""
