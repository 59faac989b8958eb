# Launch layer: the train and serve drivers, device meshes.
