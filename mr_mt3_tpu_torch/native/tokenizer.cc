// Native tokenizer core: run-length event encoding with tie-state indexing.
//
// C++ implementation of the per-song hot loop in
// mr_mt3_tpu_torch/codec/rle.py::encode_and_index_events specialized to the
// note-with-ties pipeline (NoteEventData values, NoteEncodingState state,
// note_encoding_state_to_events dumps); a copy of the JAX package's
// mr_mt3_tpu/native/tokenizer.cc. Semantics are pinned by the parity tests
// in tests/test_torch_native_tokenizer.py against the Python path and the
// JAX package's core.
//
// Token ids follow the standard MT3 codec layout: shift block starts at 0,
// then pitch/velocity/tie/program/drum blocks; offsets are passed in so any
// codec built from VocabularyConfig works.
//
// Build: mr_mt3_tpu_torch/native/_loader.py at first use
// (g++ -O2 -std=c++17 -fPIC -Wall -shared)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <map>
#include <utility>
#include <vector>

extern "C" {

struct TokenizerResult {
  int32_t* events;
  int64_t n_events;
  int32_t* event_start_indices;   // n_frames
  int32_t* event_end_indices;     // n_frames
  int32_t* state_events;
  int64_t n_state_events;
  int32_t* state_event_indices;   // n_frames
};

// Encode one song. Event values are parallel arrays; velocity_bin < 0 means
// "onsets only" (pitch-only events), program < 0 means "no program".
// Returns 0 on success, negative on error. Output arrays are allocated with
// new[] and must be released with mt3_free_result.
int mt3_encode_song(
    const double* event_times,
    const int32_t* pitches,
    const int32_t* velocity_bins,
    const int32_t* programs,
    const uint8_t* is_drums,
    int64_t n_events_in,
    const double* frame_times,
    int64_t n_frames,
    double steps_per_second,
    // codec id offsets
    int32_t shift_one_id,     // id of shift(1)
    int32_t pitch_base,       // id of pitch 0
    int32_t velocity_base,    // id of velocity bin 0
    int32_t tie_id,
    int32_t program_base,     // id of program 0
    int32_t drum_base,        // id of drum pitch 0
    uint8_t include_ties,
    TokenizerResult* out) {
  if (n_frames <= 0) return -1;

  // stable sort event indices by time
  std::vector<int64_t> order(n_events_in);
  for (int64_t i = 0; i < n_events_in; ++i) order[i] = i;
  std::stable_sort(order.begin(), order.end(),
                   [&](int64_t a, int64_t b) {
                     return event_times[a] < event_times[b];
                   });

  std::vector<int32_t> events;
  std::vector<int32_t> state_events;
  std::vector<int32_t> event_start_indices;
  std::vector<int32_t> state_event_indices;
  events.reserve(n_events_in * 3 + (int64_t)(frame_times[n_frames - 1] *
                                             steps_per_second) + 16);
  event_start_indices.reserve(n_frames);
  state_event_indices.reserve(n_frames);

  // active (program, pitch) -> velocity bin, iterated in sorted order for
  // the state dumps (python sorts keys by (program, pitch))
  std::map<std::pair<int32_t, int32_t>, int32_t> active;

  int64_t cur_step = 0;
  int64_t cur_event_idx = 0;
  int64_t cur_state_event_idx = 0;

  auto fill_frames = [&]() {
    double cur_time = (double)cur_step / steps_per_second;
    while ((int64_t)event_start_indices.size() < n_frames &&
           frame_times[event_start_indices.size()] < cur_time) {
      event_start_indices.push_back((int32_t)cur_event_idx);
      state_event_indices.push_back((int32_t)cur_state_event_idx);
    }
  };

  for (int64_t oi = 0; oi < n_events_in; ++oi) {
    int64_t i = order[oi];
    // python: round(t * sps) — banker's rounding (round-half-even)
    double scaled = event_times[i] * steps_per_second;
    double floor_v = std::floor(scaled);
    double frac = scaled - floor_v;
    int64_t event_step;
    if (frac > 0.5) {
      event_step = (int64_t)floor_v + 1;
    } else if (frac < 0.5) {
      event_step = (int64_t)floor_v;
    } else {
      int64_t f = (int64_t)floor_v;
      event_step = (f % 2 == 0) ? f : f + 1;
    }
    while (event_step > cur_step) {
      events.push_back(shift_one_id);
      ++cur_step;
      fill_frames();
      cur_event_idx = (int64_t)events.size();
      cur_state_event_idx = (int64_t)state_events.size();
    }
    if (include_ties) {
      // dump state BEFORE applying this event
      for (const auto& kv : active) {
        if (kv.second) {
          state_events.push_back(program_base + kv.first.first);
          state_events.push_back(pitch_base + kv.first.second);
        }
      }
      state_events.push_back(tie_id);
    }
    // note_event_data_to_events
    int32_t pitch = pitches[i];
    int32_t vbin = velocity_bins[i];
    int32_t program = programs[i];
    if (vbin < 0) {
      events.push_back(pitch_base + pitch);
    } else if (program < 0) {
      active[{0, pitch}] = vbin;
      events.push_back(velocity_base + vbin);
      events.push_back(pitch_base + pitch);
    } else if (is_drums[i]) {
      events.push_back(velocity_base + vbin);
      events.push_back(drum_base + pitch);
    } else {
      active[{program, pitch}] = vbin;
      events.push_back(program_base + program);
      events.push_back(velocity_base + vbin);
      events.push_back(pitch_base + pitch);
    }
  }

  // trailing shifts: non-strict inequality, as in python
  while ((double)cur_step / steps_per_second <= frame_times[n_frames - 1]) {
    events.push_back(shift_one_id);
    ++cur_step;
    fill_frames();
    cur_event_idx = (int64_t)events.size();
  }

  out->n_events = (int64_t)events.size();
  out->events = new int32_t[events.size()];
  std::copy(events.begin(), events.end(), out->events);

  out->event_start_indices = new int32_t[n_frames];
  out->event_end_indices = new int32_t[n_frames];
  std::copy(event_start_indices.begin(), event_start_indices.end(),
            out->event_start_indices);
  for (int64_t f = 0; f + 1 < n_frames; ++f)
    out->event_end_indices[f] = out->event_start_indices[f + 1];
  out->event_end_indices[n_frames - 1] = (int32_t)events.size();

  out->n_state_events = (int64_t)state_events.size();
  out->state_events = new int32_t[state_events.size()];
  std::copy(state_events.begin(), state_events.end(), out->state_events);

  out->state_event_indices = new int32_t[n_frames];
  std::copy(state_event_indices.begin(), state_event_indices.end(),
            out->state_event_indices);
  return 0;
}

void mt3_free_result(TokenizerResult* r) {
  delete[] r->events;
  delete[] r->event_start_indices;
  delete[] r->event_end_indices;
  delete[] r->state_events;
  delete[] r->state_event_indices;
  r->events = nullptr;
  r->event_start_indices = nullptr;
  r->event_end_indices = nullptr;
  r->state_events = nullptr;
  r->state_event_indices = nullptr;
}

}  // extern "C"
