"""Running-mean and timing trackers of the training loop."""

import time


class MeanTracker:
    def __init__(self):
        self.reset()

    def add(self, values, weight=1.0):
        for key, v in values.items():
            if key not in self.mean_dict:
                self.mean_dict[key] = 0.0
            self.mean_dict[key] = (
                self.mean_dict[key] * self.total_weight + float(v) * weight
            ) / (self.total_weight + weight)
        self.total_weight += weight

    def has(self, key):
        return key in self.mean_dict

    def get(self, key):
        return self.mean_dict[key]

    def as_dict(self):
        return dict(self.mean_dict)

    def reset(self):
        self.mean_dict = {}
        self.total_weight = 0.0


class TimeTracker:
    def __init__(self):
        self.start_epoch()

    def start_epoch(self):
        self.epoch_start_time = time.time()
        self.n_iterations = 0
        self.batch_time_sum = 0.0

    def start_batch(self):
        self.batch_start_time = time.time()

    def finish_batch(self):
        self.n_iterations += 1
        self.batch_end_time = time.time()
        self.batch_time_sum += self.batch_end_time - self.batch_start_time

    def get_batch_time(self):
        return self.batch_time_sum / max(self.n_iterations, 1)

    def get_iteration_time(self):
        return (self.batch_end_time - self.epoch_start_time) / max(self.n_iterations, 1)
