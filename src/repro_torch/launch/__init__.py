# Launch layer: the train driver.
