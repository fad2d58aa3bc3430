// Native host runtime for ephemeris_explorer_tpu.
//
// The device owns integration and fitting; this library owns the host-side
// serving path the explorer UI hits every frame - the role the reference's
// compiled Rust runtime plays for evaluation/plotting/picking:
//
//  * batch piecewise-polynomial evaluation over the packed ephemeris
//    (UniformSpline eval semantics: end-inclusive segment lookup, Horner
//    value + derivative; reference ephemeris/src/trajectory.rs:552-617)
//  * cubic-Hermite ship-trajectory evaluation (trajectory.rs:635-743)
//  * Principia-style PlotMethod3 adaptive polyline generation
//    (ephemeris_explorer/src/ui/world/plot.rs:89-150)
//  * polyline-vs-ray picking distances (plot.rs:176-225)
//
// Exposed as a plain C ABI consumed through ctypes (no pybind11 in the
// image).  Batch entry points shard across std::thread workers, mirroring
// the reference's par_iter_mut plot parallelism (plot.rs:273-356).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <functional>
#include <thread>
#include <vector>

namespace {

inline int64_t index_exclusive(double local, double interval, int64_t nseg) {
    // trajectory.rs:600-617: ceil(local/interval) - 1, end-inclusive
    if (local < 0.0) return -1;
    double span = interval * static_cast<double>(nseg);
    if (local > span) return -1;
    int64_t idx = static_cast<int64_t>(std::ceil(local / interval)) - 1;
    if (idx < 0) idx = 0;
    if (idx >= nseg) idx = nseg - 1;
    return idx;
}

inline void horner_and_deriv(const double* c /*9x3*/, double tau, double inv_interval,
                             double* pos, double* vel) {
    // trajectory.rs:369-385 eval_and_deriv on padded 9-coefficient segments
    for (int k = 0; k < 3; ++k) {
        double val = c[8 * 3 + k];
        double der = val;
        for (int d = 7; d >= 1; --d) {
            val = val * tau + c[d * 3 + k];
            der = der * tau + val;
        }
        val = val * tau + c[k];
        pos[k] = val;
        if (vel) vel[k] = der * inv_interval;
    }
}

struct Packed {
    const double* starts;
    const double* intervals;
    const int64_t* offsets;
    const int64_t* nsegs;
    const double* coeffs;  // (sum nsegs, 9, 3)
    int64_t n_bodies;
};

inline int eval_body(const Packed& p, int64_t b, double t, double* pos, double* vel) {
    double local = t - p.starts[b];
    int64_t idx = index_exclusive(local, p.intervals[b], p.nsegs[b]);
    if (idx < 0) return 0;
    double tau = (local - p.intervals[b] * static_cast<double>(idx)) / p.intervals[b];
    const double* c = p.coeffs + (p.offsets[b] + idx) * 27;
    horner_and_deriv(c, tau, 1.0 / p.intervals[b], pos, vel);
    return 1;
}

void run_sharded(int64_t n, int n_threads, const std::function<void(int64_t, int64_t)>& fn) {
    if (n_threads <= 1 || n < 1024) {
        fn(0, n);
        return;
    }
    std::vector<std::thread> ts;
    int64_t chunk = (n + n_threads - 1) / n_threads;
    for (int i = 0; i < n_threads; ++i) {
        int64_t lo = i * chunk;
        int64_t hi = std::min(n, lo + chunk);
        if (lo >= hi) break;
        ts.emplace_back(fn, lo, hi);
    }
    for (auto& t : ts) t.join();
}

}  // namespace

extern "C" {

// Evaluate every body at every time: out_pos/out_vel are (n_times, n_bodies, 3);
// ok is (n_times, n_bodies) 0/1 coverage flags.  out_vel may be null.
void eet_spline_eval_batch(const double* starts, const double* intervals,
                           const int64_t* offsets, const int64_t* nsegs,
                           const double* coeffs, int64_t n_bodies,
                           const double* times, int64_t n_times,
                           double* out_pos, double* out_vel, uint8_t* ok,
                           int n_threads) {
    Packed p{starts, intervals, offsets, nsegs, coeffs, n_bodies};
    run_sharded(n_times, n_threads, [&](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; ++i) {
            for (int64_t b = 0; b < n_bodies; ++b) {
                double* pos = out_pos + (i * n_bodies + b) * 3;
                double* vel = out_vel ? out_vel + (i * n_bodies + b) * 3 : nullptr;
                ok[i * n_bodies + b] =
                    static_cast<uint8_t>(eval_body(p, b, times[i], pos, vel));
            }
        }
    });
}

// Cubic-Hermite evaluation over ship knots (ts strictly increasing).
// out_pos/out_vel (n_times, 3); ok (n_times,).
void eet_hermite_eval_batch(const double* ts, const double* pos, const double* vel,
                            int64_t n_knots, const double* times, int64_t n_times,
                            double* out_pos, double* out_vel, uint8_t* ok,
                            int n_threads) {
    run_sharded(n_times, n_threads, [&](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; ++i) {
            double t = times[i];
            if (n_knots == 0 || t < ts[0] || t > ts[n_knots - 1]) {
                ok[i] = 0;
                continue;
            }
            // binary search for the segment (trajectory.rs:812-814)
            int64_t a = 0, b = n_knots - 1;
            while (b - a > 1) {
                int64_t m = (a + b) / 2;
                if (ts[m] <= t) a = m; else b = m;
            }
            if (ts[a] == t) {
                for (int k = 0; k < 3; ++k) {
                    out_pos[i * 3 + k] = pos[a * 3 + k];
                    if (out_vel) out_vel[i * 3 + k] = vel[a * 3 + k];
                }
                ok[i] = 1;
                continue;
            }
            double t0 = ts[a], t1 = ts[a + 1];
            double dt = t1 - t0;
            double x = t - t0;
            for (int k = 0; k < 3; ++k) {
                double p0 = pos[a * 3 + k], p1 = pos[(a + 1) * 3 + k];
                double v0 = vel[a * 3 + k], v1 = vel[(a + 1) * 3 + k];
                double dpv = p1 - p0;
                double a2 = dpv * 3.0 / (dt * dt) - (v0 * 2.0 + v1) / dt;
                double a3 = dpv * -2.0 / (dt * dt * dt) + (v0 + v1) / (dt * dt);
                out_pos[i * 3 + k] = ((a3 * x + a2) * x + v0) * x + p0;
                if (out_vel) out_vel[i * 3 + k] = (a3 * x * 3.0 + a2 * 2.0) * x + v0;
            }
            ok[i] = 1;
        }
    });
}

// PlotMethod3 adaptive polyline over one packed-ephemeris body.
// Returns the number of points written (<= max_points); -1 on eval failure.
int64_t eet_plot_polyline(const double* starts, const double* intervals,
                          const int64_t* offsets, const int64_t* nsegs,
                          const double* coeffs, int64_t n_bodies, int64_t body,
                          double t_min, double t_max, const double* cam,
                          double tan2_res, int64_t max_points,
                          double* out_times, double* out_points) {
    Packed p{starts, intervals, offsets, nsegs, coeffs, n_bodies};
    if (max_points <= 0) return 0;
    double target = tan2_res * tan2_res;

    double prev_t = t_min;
    double prev_pos[3], prev_vel[3];
    if (!eval_body(p, body, prev_t, prev_pos, prev_vel)) return -1;
    double delta = t_max - prev_t;
    double est = -1.0;

    int64_t n = 0;
    out_times[n] = prev_t;
    for (int k = 0; k < 3; ++k) out_points[n * 3 + k] = prev_pos[k];
    ++n;

    while (prev_t < t_max && n < max_points) {
        double t, cur_pos[3], cur_vel[3], error;
        for (;;) {
            if (est > 0.0) delta = delta * 0.9 * std::sqrt(std::sqrt(target / est));
            t = prev_t + delta;
            if (t > t_max) t = t_max;
            delta = t - prev_t;
            double extrap[3];
            for (int k = 0; k < 3; ++k) extrap[k] = prev_pos[k] + prev_vel[k] * delta;
            if (!eval_body(p, body, t, cur_pos, cur_vel)) return -1;
            // angular_distance (plot.rs:429-436) / 16
            double v1[3], v2[3], n1 = 0, n2 = 0;
            for (int k = 0; k < 3; ++k) {
                v1[k] = extrap[k] - cam[k];
                v2[k] = cur_pos[k] - cam[k];
                n1 += v1[k] * v1[k];
                n2 += v2[k] * v2[k];
            }
            n1 = std::sqrt(n1); n2 = std::sqrt(n2);
            double dot = 0;
            double wx = v1[1] * v2[2] - v1[2] * v2[1];
            double wy = v1[2] * v2[0] - v1[0] * v2[2];
            double wz = v1[0] * v2[1] - v1[1] * v2[0];
            for (int k = 0; k < 3; ++k) dot += v1[k] * v2[k];
            dot /= (n1 * n2);
            double wedge2 = (wx * wx + wy * wy + wz * wz) / (n1 * n1 * n2 * n2);
            error = wedge2 / (dot * dot) / 16.0;
            if (error <= target) break;
            est = error;
        }
        prev_t = t;
        for (int k = 0; k < 3; ++k) { prev_pos[k] = cur_pos[k]; prev_vel[k] = cur_vel[k]; }
        est = error;
        out_times[n] = t;
        for (int k = 0; k < 3; ++k) out_points[n * 3 + k] = cur_pos[k];
        ++n;
    }
    return n;
}

// Segment-vs-ray picking distances (plot.rs:176-225).
// out (n-1, 3): (event_time, separation, t_ray); mask (n-1,) validity.
void eet_ray_distances(const double* times, const double* pts, int64_t n,
                       const double* origin, const double* dir, double max_ray,
                       double* out, uint8_t* mask) {
    double c = dir[0] * dir[0] + dir[1] * dir[1] + dir[2] * dir[2];
    for (int64_t i = 0; i + 1 < n; ++i) {
        const double* p1 = pts + i * 3;
        const double* p2 = pts + (i + 1) * 3;
        double u[3], w[3];
        for (int k = 0; k < 3; ++k) {
            u[k] = p2[k] - p1[k];
            w[k] = p1[k] - origin[k];
        }
        double a = u[0] * u[0] + u[1] * u[1] + u[2] * u[2];
        double b = u[0] * dir[0] + u[1] * dir[1] + u[2] * dir[2];
        double d = u[0] * w[0] + u[1] * w[1] + u[2] * w[2];
        double e = w[0] * dir[0] + w[1] * dir[1] + w[2] * dir[2];
        double denom = a * c - b * b;
        double t_seg, t_ray;
        if (denom < 1e-7) {
            t_seg = 0.0;
            t_ray = (b > c) ? d / b : e / c;
        } else {
            t_seg = (b * e - c * d) / denom;
            t_ray = (a * e - b * d) / denom;
        }
        if (t_ray > max_ray || t_seg < 0.0 || t_seg > 1.0) {
            mask[i] = 0;
            continue;
        }
        double sep2 = 0;
        for (int k = 0; k < 3; ++k) {
            double ps = p1[k] + u[k] * t_seg;
            double pr = origin[k] + dir[k] * t_ray;
            sep2 += (pr - ps) * (pr - ps);
        }
        out[i * 3 + 0] = times[i] + (times[i + 1] - times[i]) * t_seg;
        out[i * 3 + 1] = std::sqrt(sep2);
        out[i * 3 + 2] = t_ray;
        mask[i] = 1;
    }
}

}  // extern "C"
