"""The configurations the benchmark runs train without the FAN heatmap loss
(``hmap_loss_lambda`` 0), so the reference carries no FAN."""


def fan_heatmap_fn(fan, fan_input_size):
    raise NotImplementedError("the reference has no FAN: the heatmap loss is off")
