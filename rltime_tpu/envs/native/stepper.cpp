// Native batched environment stepper (SURVEY.md §2a).
//
// The reference's env throughput comes from Python subprocess workers
// around per-env emulators; this build replaces that with an
// in-process C++ lane pool stepped in lockstep: one call advances all
// E lanes, writing fixed-shape output buffers the caller hands straight
// to jax.device_put. A worker thread pool shards lanes across cores
// (emulator stepping releases no GIL to fight over — we never re-enter
// Python inside the loop).
//
// Implemented environments:
//   * CartPole-v1 (gymnasium-exact Euler dynamics) — the [BJ] config
//     #1 task, used to validate the native path end-to-end and as the
//     throughput microbenchmark baseline.
//   * Atari-shaped lanes (84x84 uint8 obs, DeepMind stack in C++):
//     the REAL ALE lane compiles when ALE headers are present
//     (-DRLTIME_HAVE_ALE, probed by bindings.build_library) and is a
//     drop-in; otherwise a SYNTHETIC lane with the same per-step work
//     profile (full 210x160x3 screen traffic, frameskip max-pool,
//     grayscale + area resize to 84x84) stands in — it proves the
//     engine machinery (threads, buffers, Python boundary) against
//     the SURVEY.md §7 throughput budget without the emulator.
//
// C ABI only — bound from Python with ctypes (no pybind11 in image).

#ifdef RLTIME_HAVE_ALE
#include <ale_interface.hpp>
#endif

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <mutex>
#include <random>
#include <thread>
#include <vector>

namespace {

constexpr double kGravity = 9.8;
constexpr double kMassCart = 1.0;
constexpr double kMassPole = 0.1;
constexpr double kTotalMass = kMassCart + kMassPole;
constexpr double kLength = 0.5;
constexpr double kPoleMassLength = kMassPole * kLength;
constexpr double kForceMag = 10.0;
constexpr double kTau = 0.02;
constexpr double kThetaThreshold = 12.0 * 2.0 * M_PI / 360.0;
constexpr double kXThreshold = 2.4;

struct CartPoleLane {
  double s[4];
  int64_t steps = 0;
  std::mt19937_64 rng;

  void reset_state() {
    std::uniform_real_distribution<double> d(-0.05, 0.05);
    for (double& v : s) v = d(rng);
    steps = 0;
  }

  // One env step; returns (reward, terminated, truncated) via outs.
  void step(int32_t action, int32_t time_limit, float* obs_out,
            float* rew_out, uint8_t* term_out, uint8_t* trunc_out) {
    const double force = action == 1 ? kForceMag : -kForceMag;
    const double x = s[0], x_dot = s[1], th = s[2], th_dot = s[3];
    const double costh = std::cos(th), sinth = std::sin(th);
    const double temp =
        (force + kPoleMassLength * th_dot * th_dot * sinth) / kTotalMass;
    const double th_acc =
        (kGravity * sinth - costh * temp) /
        (kLength * (4.0 / 3.0 - kMassPole * costh * costh / kTotalMass));
    const double x_acc = temp - kPoleMassLength * th_acc * costh / kTotalMass;
    s[0] = x + kTau * x_dot;
    s[1] = x_dot + kTau * x_acc;
    s[2] = th + kTau * th_dot;
    s[3] = th_dot + kTau * th_acc;
    steps += 1;

    const bool terminated =
        std::fabs(s[0]) > kXThreshold || std::fabs(s[2]) > kThetaThreshold;
    const bool truncated = !terminated && steps >= time_limit;
    *rew_out = 1.0f;
    *term_out = terminated ? 1 : 0;
    *trunc_out = truncated ? 1 : 0;
    if (terminated || truncated) reset_state();
    for (int i = 0; i < 4; ++i) obs_out[i] = static_cast<float>(s[i]);
  }
};

// Lockstep lane pool: persistent worker threads, range-sharded lanes.
class LanePool {
 public:
  LanePool(int num_lanes, int num_threads)
      : num_lanes_(num_lanes),
        num_threads_(std::max(1, num_threads)) {
    if (num_threads_ > 1) {
      workers_.reserve(num_threads_);
      for (int w = 0; w < num_threads_; ++w) {
        workers_.emplace_back([this, w] { worker_loop(w); });
      }
    }
  }

  ~LanePool() {
    {
      std::unique_lock<std::mutex> lk(mu_);
      shutdown_ = true;
      epoch_ += 1;
    }
    cv_work_.notify_all();
    for (auto& t : workers_) t.join();
  }

  // Run fn(lane_begin, lane_end) across the pool and wait.
  void parallel_for(const std::function<void(int, int)>& fn) {
    if (num_threads_ <= 1) {
      fn(0, num_lanes_);
      return;
    }
    {
      std::unique_lock<std::mutex> lk(mu_);
      fn_ = &fn;
      pending_ = num_threads_;
      epoch_ += 1;
    }
    cv_work_.notify_all();
    std::unique_lock<std::mutex> lk(mu_);
    cv_done_.wait(lk, [this] { return pending_ == 0; });
  }

 private:
  void worker_loop(int w) {
    int64_t seen = 0;
    const int per = (num_lanes_ + num_threads_ - 1) / num_threads_;
    const int begin = std::min(w * per, num_lanes_);
    const int end = std::min(begin + per, num_lanes_);
    while (true) {
      const std::function<void(int, int)>* fn = nullptr;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_work_.wait(lk, [&] { return epoch_ != seen; });
        seen = epoch_;
        if (shutdown_) return;
        fn = fn_;
      }
      (*fn)(begin, end);
      {
        std::unique_lock<std::mutex> lk(mu_);
        if (--pending_ == 0) cv_done_.notify_all();
      }
    }
  }

  const int num_lanes_;
  const int num_threads_;
  std::vector<std::thread> workers_;
  std::mutex mu_;
  std::condition_variable cv_work_, cv_done_;
  const std::function<void(int, int)>* fn_ = nullptr;
  int pending_ = 0;
  int64_t epoch_ = 0;
  bool shutdown_ = false;
};

struct CartPolePool {
  std::vector<CartPoleLane> lanes;
  LanePool pool;
  int32_t time_limit;

  CartPolePool(int n, uint64_t seed, int threads, int32_t limit)
      : pool(n, threads), time_limit(limit) {
    lanes.resize(n);
    for (int i = 0; i < n; ++i) {
      lanes[i].rng.seed(seed + static_cast<uint64_t>(i) * 0x9E3779B97F4A7C15ULL);
      lanes[i].reset_state();
    }
  }
};

// ------------- Atari-shaped emulator lanes (SURVEY.md §2a) ----------

constexpr int kScreenH = 210, kScreenW = 160;
constexpr int kObsH = 84, kObsW = 84;

// Luminance of the per-pixel max of two RGB screens, box-resampled to
// 84x84 (integer area average — the C++ analog of the Python stack's
// grayscale + INTER_AREA in envs/atari.py:preprocess_frame; exact cv2
// parity is not claimed and is documented at the binding).
inline void gray_max_resize(const uint8_t* rgb0, const uint8_t* rgb1,
                            uint8_t* out84) {
  static thread_local std::vector<uint16_t> gray(kScreenH * kScreenW);
  for (int p = 0; p < kScreenH * kScreenW; ++p) {
    const uint8_t r = std::max(rgb0[p * 3 + 0], rgb1[p * 3 + 0]);
    const uint8_t g = std::max(rgb0[p * 3 + 1], rgb1[p * 3 + 1]);
    const uint8_t b = std::max(rgb0[p * 3 + 2], rgb1[p * 3 + 2]);
    gray[p] = static_cast<uint16_t>((299 * r + 587 * g + 114 * b) / 1000);
  }
  for (int i = 0; i < kObsH; ++i) {
    const int y0 = i * kScreenH / kObsH, y1 = (i + 1) * kScreenH / kObsH;
    for (int j = 0; j < kObsW; ++j) {
      const int x0 = j * kScreenW / kObsW, x1 = (j + 1) * kScreenW / kObsW;
      uint32_t acc = 0;
      for (int y = y0; y < y1; ++y)
        for (int x = x0; x < x1; ++x) acc += gray[y * kScreenW + x];
      out84[i * kObsW + j] =
          static_cast<uint8_t>(acc / ((y1 - y0) * (x1 - x0)));
    }
  }
}

struct AtariLaneConfig {
  int noop_max = 30;
  int frameskip = 4;
  bool episodic_life = true;
  bool fire_reset = true;
  int64_t max_episode_frames = 108000;
};

#ifdef RLTIME_HAVE_ALE
// Real emulator lane: the DeepMind stack of envs/atari.py:_AtariLane
// executed natively (noop/fire reset, frameskip with 2-frame max-pool
// seam, EpisodicLife vs game-over reset, truncation). Drop-in: same
// C ABI as the synthetic lane; atari_backend() reports 1.
struct AtariLane {
  ale::ALEInterface ale_;
  std::vector<ale::Action> actions;
  AtariLaneConfig cfg;
  std::mt19937_64 rng;
  std::vector<uint8_t> screens[2];
  int lives = 0;
  int64_t frame_count = 0;

  void init(uint64_t seed, const char* rom, const AtariLaneConfig& c) {
    cfg = c;
    rng.seed(seed);
    ale_.setInt("random_seed", static_cast<int>(seed & 0x7fffffff));
    ale_.setFloat("repeat_action_probability", 0.0f);
    ale_.loadROM(rom);
    actions = ale_.getMinimalActionSet();
    screens[0].resize(kScreenH * kScreenW * 3);
    screens[1].resize(kScreenH * kScreenW * 3);
  }

  int num_actions() const { return static_cast<int>(actions.size()); }

  void screen(int i) { ale_.getScreenRGB(screens[i]); }

  void reset_episode(uint8_t* obs_out) {
    ale_.reset_game();
    if (cfg.noop_max > 0) {  // noop_max=0 disables noop-starts; a
      // (1, 0) uniform_int_distribution would be UB (advisor r4)
      std::uniform_int_distribution<int> d(1, cfg.noop_max);
      for (int k = d(rng); k > 0; --k) {
        ale_.act(ale::PLAYER_A_NOOP);
        if (ale_.game_over()) ale_.reset_game();
      }
    }
    if (cfg.fire_reset && actions.size() >= 3) {
      ale_.act(actions[1]);
      if (ale_.game_over()) ale_.reset_game();
    }
    lives = ale_.lives();
    frame_count = 0;
    screen(0);
    screens[1] = screens[0];
    gray_max_resize(screens[0].data(), screens[1].data(), obs_out);
  }

  void step(int32_t action_idx, uint8_t* obs_out, float* rew_out,
            uint8_t* term_out, uint8_t* trunc_out, uint8_t* over_out) {
    const ale::Action a = actions[action_idx];
    float total = 0.0f;
    for (int k = 0; k < cfg.frameskip; ++k) {
      total += static_cast<float>(ale_.act(a));
      if (k >= cfg.frameskip - 2) screen(k - (cfg.frameskip - 2));
      if (ale_.game_over()) break;
    }
    frame_count += cfg.frameskip;
    const bool game_over = ale_.game_over();
    const bool lost_life = cfg.episodic_life && ale_.lives() < lives;
    const bool terminated = game_over || lost_life;
    const bool truncated =
        !terminated && frame_count >= cfg.max_episode_frames;
    *rew_out = total;
    *term_out = terminated ? 1 : 0;
    *trunc_out = truncated ? 1 : 0;
    *over_out = (game_over || truncated) ? 1 : 0;
    if (game_over || truncated) {
      reset_episode(obs_out);
    } else if (lost_life) {
      if (cfg.fire_reset && actions.size() >= 3) ale_.act(actions[1]);
      lives = ale_.lives();
      screen(0);
      screens[1] = screens[0];
      gray_max_resize(screens[0].data(), screens[1].data(), obs_out);
    } else {
      gray_max_resize(screens[0].data(), screens[1].data(), obs_out);
    }
  }
};
#else
// Synthetic stand-in: deterministic screen dynamics with emulator-like
// memory traffic. Each "frame" scrolls a procedural background band
// and draws a moving sprite into the full 210x160x3 screen buffer;
// rewards/lives/game-over follow a seeded schedule. NOT a game — a
// load generator for the engine throughput proof.
struct AtariLane {
  AtariLaneConfig cfg;
  uint64_t rng;
  std::vector<uint8_t> screens[2];
  int lives = 3;
  int64_t frame_count = 0;
  int64_t ep_steps = 0;
  int64_t next_life_loss = 0;
  int scroll = 0;

  uint64_t next_rand() {
    rng = rng * 6364136223846793005ULL + 1442695040888963407ULL;
    return rng >> 33;
  }

  void init(uint64_t seed, const char* /*rom*/,
            const AtariLaneConfig& c) {
    cfg = c;
    rng = seed * 0x9E3779B97F4A7C15ULL + 0xD1B54A32D192ED03ULL;
    screens[0].assign(kScreenH * kScreenW * 3, 0);
    screens[1].assign(kScreenH * kScreenW * 3, 0);
  }

  int num_actions() const { return 6; }

  void emulate_frame(int buf, int32_t action) {
    // scroll one band + draw a sprite: ~3 rows of writes per frame,
    // deterministic from (rng, action).
    uint8_t* s = screens[buf].data();
    scroll = (scroll + 1) % kScreenH;
    const uint8_t v = static_cast<uint8_t>(next_rand());
    std::memset(s + scroll * kScreenW * 3,
                static_cast<int>(v ^ (action * 37)), kScreenW * 3);
    const int sy = static_cast<int>(next_rand() % (kScreenH - 8));
    const int sx = static_cast<int>(next_rand() % (kScreenW - 8));
    for (int y = 0; y < 8; ++y)
      std::memset(s + ((sy + y) * kScreenW + sx) * 3, 255, 8 * 3);
  }

  void reset_episode(uint8_t* obs_out) {
    lives = 3;
    frame_count = 0;
    ep_steps = 0;
    next_life_loss =
        50 + static_cast<int64_t>(next_rand() % 150);  // steps
    emulate_frame(0, 0);
    screens[1] = screens[0];
    gray_max_resize(screens[0].data(), screens[1].data(), obs_out);
  }

  void step(int32_t action, uint8_t* obs_out, float* rew_out,
            uint8_t* term_out, uint8_t* trunc_out, uint8_t* over_out) {
    for (int k = 0; k < cfg.frameskip; ++k)
      emulate_frame(k >= cfg.frameskip - 2 ? k - (cfg.frameskip - 2)
                                           : 0,
                    action);
    frame_count += cfg.frameskip;
    ep_steps += 1;
    const bool lost_life =
        cfg.episodic_life && ep_steps >= next_life_loss;
    if (lost_life) {
      lives -= 1;
      next_life_loss =
          ep_steps + 50 + static_cast<int64_t>(next_rand() % 150);
    }
    const bool game_over = lives <= 0;
    const bool terminated = game_over || lost_life;
    const bool truncated =
        !terminated && frame_count >= cfg.max_episode_frames;
    *rew_out = (next_rand() % 8 == 0) ? 1.0f : 0.0f;
    *term_out = terminated ? 1 : 0;
    *trunc_out = truncated ? 1 : 0;
    *over_out = (game_over || truncated) ? 1 : 0;
    if (game_over || truncated) {
      reset_episode(obs_out);
    } else {
      gray_max_resize(screens[0].data(), screens[1].data(), obs_out);
    }
  }
};
#endif  // RLTIME_HAVE_ALE

struct AtariPool {
  std::vector<AtariLane> lanes;
  LanePool pool;

  AtariPool(int n, uint64_t seed, int threads, const char* rom,
            const AtariLaneConfig& cfg)
      : lanes(n), pool(n, threads) {
    for (int i = 0; i < n; ++i)
      lanes[i].init(seed + static_cast<uint64_t>(i) * 1000003ULL, rom,
                    cfg);
  }
};

}  // namespace

extern "C" {

void* cartpole_create(int32_t num_lanes, uint64_t seed,
                      int32_t num_threads, int32_t time_limit) {
  return new CartPolePool(num_lanes, seed, num_threads, time_limit);
}

void cartpole_destroy(void* handle) {
  delete static_cast<CartPolePool*>(handle);
}

void cartpole_reset(void* handle, uint64_t seed, float* obs_out) {
  auto* p = static_cast<CartPolePool*>(handle);
  for (size_t i = 0; i < p->lanes.size(); ++i) {
    p->lanes[i].rng.seed(seed + static_cast<uint64_t>(i) * 0x9E3779B97F4A7C15ULL);
    p->lanes[i].reset_state();
    for (int k = 0; k < 4; ++k)
      obs_out[i * 4 + k] = static_cast<float>(p->lanes[i].s[k]);
  }
}

void cartpole_step(void* handle, const int32_t* actions, float* obs_out,
                   float* rew_out, uint8_t* term_out, uint8_t* trunc_out) {
  auto* p = static_cast<CartPolePool*>(handle);
  p->pool.parallel_for([&](int begin, int end) {
    for (int i = begin; i < end; ++i) {
      p->lanes[i].step(actions[i], p->time_limit, obs_out + i * 4,
                       rew_out + i, term_out + i, trunc_out + i);
    }
  });
}

// Multi-step fused rollout with a caller-provided action table:
// actions laid out (steps, lanes); outputs (steps, lanes, ...).
// Amortizes the Python boundary to one call per chunk when the policy
// is cheap/scripted (benchmarks; random warmup).
void cartpole_step_many(void* handle, int32_t steps,
                        const int32_t* actions, float* obs_out,
                        float* rew_out, uint8_t* term_out,
                        uint8_t* trunc_out) {
  auto* p = static_cast<CartPolePool*>(handle);
  const size_t n = p->lanes.size();
  p->pool.parallel_for([&](int begin, int end) {
    for (int32_t t = 0; t < steps; ++t) {
      const size_t base = static_cast<size_t>(t) * n;
      for (int i = begin; i < end; ++i) {
        p->lanes[i].step(actions[base + i], p->time_limit,
                         obs_out + (base + i) * 4, rew_out + base + i,
                         term_out + base + i, trunc_out + base + i);
      }
    }
  });
}

// ---- Atari-shaped lanes (real ALE when compiled with
// -DRLTIME_HAVE_ALE, synthetic load generator otherwise) ----

int32_t atari_backend() {
#ifdef RLTIME_HAVE_ALE
  return 1;
#else
  return 0;
#endif
}

void* atari_create(int32_t num_lanes, uint64_t seed,
                   int32_t num_threads, const char* rom,
                   int32_t noop_max, int32_t frameskip,
                   int32_t episodic_life, int32_t fire_reset,
                   int64_t max_episode_frames) {
  AtariLaneConfig cfg;
  cfg.noop_max = noop_max;
  cfg.frameskip = frameskip;
  cfg.episodic_life = episodic_life != 0;
  cfg.fire_reset = fire_reset != 0;
  cfg.max_episode_frames = max_episode_frames;
  return new AtariPool(num_lanes, seed, num_threads, rom, cfg);
}

void atari_destroy(void* handle) {
  delete static_cast<AtariPool*>(handle);
}

int32_t atari_num_actions(void* handle) {
  return static_cast<AtariPool*>(handle)->lanes[0].num_actions();
}

void atari_reset(void* handle, uint8_t* obs_out) {
  auto* p = static_cast<AtariPool*>(handle);
  p->pool.parallel_for([&](int begin, int end) {
    for (int i = begin; i < end; ++i)
      p->lanes[i].reset_episode(obs_out + i * kObsH * kObsW);
  });
}

// Outputs: obs (E,84,84) uint8; rew RAW (caller clips); term/trunc;
// over = whole-game over (true-score boundary, envs/atari.py).
void atari_step(void* handle, const int32_t* actions, uint8_t* obs_out,
                float* rew_out, uint8_t* term_out, uint8_t* trunc_out,
                uint8_t* over_out) {
  auto* p = static_cast<AtariPool*>(handle);
  p->pool.parallel_for([&](int begin, int end) {
    for (int i = begin; i < end; ++i) {
      p->lanes[i].step(actions[i], obs_out + i * kObsH * kObsW,
                       rew_out + i, term_out + i, trunc_out + i,
                       over_out + i);
    }
  });
}

}  // extern "C"
